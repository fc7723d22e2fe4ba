#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``lightgbm_tpu_torch``).

    python3 chip_smoke.py [--seed 0] [--trees 40] [--leaves 255]
    python3 chip_smoke.py --planes-route-only   # phase 3 and B1/B3 timings
    python3 chip_smoke.py --forest-only   # phase 4's model and B8 timings
    python3 chip_smoke.py --fused-only    # phases 3b, 3d and 3e, the commit
                                          # and the chain's kernels
    python3 chip_smoke.py --file-only     # phase 2b: host IO and the CLI
    python3 chip_smoke.py --rank-only     # phases 3f and 3g: ranking and
                                          # the other objectives
    python3 chip_smoke.py --options-only  # phase 3h: the per-node split
                                          # options, forced splits, GOSS
                                          # compaction
    python3 chip_smoke.py --monotone-only # phase 3i: intermediate and
                                          # advanced monotone, DART, RF
    python3 chip_smoke.py --linear-dense-only  # phase 3j: linear trees,
                                               # the dense builder
    python3 chip_smoke.py --api-online-only    # phase 3k: cv, sklearn,
                                               # refit, SHAP, convert,
                                               # online training
    python3 chip_smoke.py --fleet-only    # phase 3l: the raw walk, a
                                          # trainer and two replicas,
                                          # failover, compaction
    python3 chip_smoke.py --parallel-only # phase 3m: the distributed
                                          # learners, rank groups of 2
                                          # and 4 on the card
    python3 chip_smoke.py --profile-only [--root DIR]  # the chain's and
                                          # B7's profiled fused blocks,
                                          # of the checkout in DIR

Needs one CUDA card (an H100: the kernels are built for ``sm_90a``) and
the checkout it sits in. Twenty phases, each fatal on failure:

1. build     -- compile the hand-written kernels (``csrc/*.cu``: fifteen
                sources, twenty-three entry points), one nvcc per source,
                started together; then the two host libraries
                (``native/parser.cpp``, ``native/binning.cpp``) with g++.
2. kernels   -- hold each kernel against its plain torch twin on the card:
                the forest kernel on small seeded packs covering every
                branch (numerical, NaN-missing, categorical, multiclass
                K=3, linear, linear + NaN); the row router with and without
                EFB bundle columns; the segment partition on both layouts
                (bytes and left counts equal: unaligned starts, empty
                sides, a segment under one block, one row, an EFB bundle
                column; rows of W = F + 12 and F + 3 bytes, F = 27 and 28);
                the segment histogram on both layouts (counts equal; g/h
                within the f32 summation bound ``ops.histogram.
                sum_error_bound`` of the twin's float64 sum of the same
                per-row values; hi/lo and bf16 modes; 0 rows to 9000;
                bit-equal run to run and with ``cnt_bound`` at the count,
                2x and 8x it: the summation order depends on the rows
                alone; the rows kernel bit-equal to the planes kernel on
                the same rows); the int8 histogram
                (byte-equal to its twin and run to run); the one-kernel
                split against its twin and against K3 + K4 (routed bytes
                and lt equal, child histograms bit-equal to K3 + K4 and
                the parent subtraction; unaligned start, empty sides,
                one-row children, a segment under one tile, bagged
                segments whose smaller child by the count channel holds
                ~3/4 of the rows) and its split
                scan against torch's on the same histograms in every case
                of SPLIT_CASES (NaN-missing both ways, one-vs-rest and
                both many-vs-many orders, monotone with both depth-penalty
                branches, a masked feature, no valid split, NaN gains,
                exact ties). The resident layout's kernels on a sparse
                ascending segment (a deep leaf's rows in the resident
                planes, stale junk elsewhere): the route gather (bytes
                equal to the twin's and the planes column), the resident
                histogram (against its twin as above, bit-equal to the
                planes kernel on the same rows; 0 rows to 9000), the
                one-kernel split's resident mode against its twin, the
                resident three-launch chain and its planes mode on the
                same rows (routed bytes and lt equal, histograms and every
                SplitInfo field bit-equal) on segment shapes and every case
                of SPLIT_CASES. The planes partition's edge cases at W = 17
                and 40 (the counts where its launch changes shape, the
                resident limits included, all-left, all-right and
                alternating tables, buffer 1 as the source) and the
                router's (a 254-round chain, a tree that always splits leaf
                0, padded rounds, num_splits 0 and past the table, bundle
                columns with out-of-range slots, a 4000-round tree; 28, 136
                and 3000 columns): phase_planes_route_kernels. The forest
                kernel's edges (FOREST_EDGE_CASES: a 254-round chain, trees
                that always split slot 0, padded rounds, num_splits 0 and
                past R, padded trees, movable-missing bins, categorical, 3
                classes, linear + NaN, 1000 features with and without
                categorical rounds, whose bins are read from device
                memory; at 1, 255, 257 and 4097 rows; one class bit-equal
                to the twin): phase_forest_kernels. The split commit against
                its twin on seeded states (COMMIT_CASES: tied and NaN
                gains, max_depth, monotone bounds, live 0, the final
                commit; every table bit-equal): phase_commit_kernel; the
                one-kernel split through its device header (the parent in
                a pool row, live 0 a no-op): phase_one_kernel_header. The
                three-launch chain's launches on a split header with
                plans sized for a 2M-row root against the per-split path
                (route gather, K3, K4 / K5 on the planes, rows, int8 and
                resident layouts, CHAIN_CASES, a dead header a no-op), the
                split scan kernel against find_best_split run by torch on
                the card on every SPLIT_CASES case, bit for bit, and the
                router with a categorical table against its twin:
                phase_chain_kernels.
                Again at 2M rows after
                phases 3, 3c and 4,
                on their data and first root splits (3c also on a deep
                leaf). Leaf ids must be equal, scores within SCORE_ATOL +
                SCORE_RTOL * |b|.
2b. file     -- the slice-12 path: ``Dataset.construct`` of the 2.1M
                training and valid rows by the native route and by numpy
                (bins byte-equal, both timed); then FILE_TRAIN_ROWS and
                FILE_VALID_ROWS of them written as CSV files, parsed
                natively (equal to the arrays bit for bit), binned and
                trained on the card (FILE_TREES trees), and the same
                through ``lightgbm_tpu_torch.cli``: ``task=train`` (the
                model byte-equal to ``train``'s; the one-kernel split, the
                split commit and the router launched), ``task=predict``
                (scores against the trained booster's ``predict``, which
                launches the forest kernel; a model read from its file
                has no bin mappers and launches the raw-threshold walk),
                ``task=save_binary`` and
                ``task=train`` from the ``.bin`` (the same model), and one
                ``python -m lightgbm_tpu_torch config=...`` subprocess
                (exit 0, the same model). Parse, construct, train and each
                task timed (alone: ``--file-only``).
3. planes    -- the slice-2 training path: 2,000,000 Higgs-shaped rows x
                28 features (max_bin=255), ``objective=binary``,
                ``num_leaves=255``, ``--trees`` iterations through
                ``lightgbm_tpu_torch.train`` with a 100,000-row valid set.
                Launch counts are zeroed just before and read just after:
                the partition, histogram and router kernels must have run.
                Every tree's leaf segment counts must equal the router's
                per-leaf row counts and sum to N, and the histogram count
                channel the in-bag rows. Two 2-iteration runs must give
                byte-equal model strings; 3 iterations on 200,000 rows on
                the card and on the host (the plain twins) must agree in
                train logloss within LOGLOSS_TOL; at the default sizes the
                model string's sha256 must be PLANES_MODEL_SHA256. The
                planes partition against its twin on PLANES_SEGMENTS (the
                2M root, the leaf nearest 64k rows, the leaf nearest 8k
                rows) at W = 40 and on the slim rows' W = 17, and the
                router with the first tree on the 2M training rows, the
                valid set, a 65,536-row serving rung and a chain tree,
                timed there by device time and the host clock (alone:
                ``--planes-route-only``).
3b. one kernel -- the slice-4 path: phase 3's data and trees with
                ``tpu_split_kernel=on``, one cooperative launch per split
                (``one_kernel_split`` launches = splits, no K3, K4 only for
                the roots); the same per-tree checks, byte-equal
                determinism, on vs off and card vs host on 200,000 rows x
                3 trees (train logloss within LOGLOSS_TOL), valid AUC
                within ONE_KERNEL_AUC_TOL of phase 3's; at the default
                sizes the model string's sha256 must be
                ONE_KERNEL_MODEL_SHA256.
3c. resident -- the slice-5 path: phase 3's data and trees with
                RESIDENT_PARAMS (``tpu_resident_state=on``,
                ``tpu_split_kernel=on``): the slim rows, the bins gathered
                from the router's planes (``one_kernel_split_resident``
                launches = splits, the resident histogram only for the
                roots, no K3, K4 or route gather); the same per-tree checks;
                the model string byte-equal to phase 3b's, served on 4096
                valid rows against the plain path; byte-equal
                determinism; on 200,000 rows x 3 trees, resident
                three-launch training (route gather, K3, the resident
                histogram) byte-equal to planes three-launch, and card vs
                host within LOGLOSS_TOL.
3d. fused    -- the slice-10 and slice-11 paths: phase 3b's data and
                params through ``train`` with no valid set and no callback
                (fused blocks of 10 trees; each tree one replay of the
                learner's CUDA graph: the root, (split commit, split) x
                254, a final commit, the router), then RESIDENT_PARAMS,
                then TRAIN_PARAMS (the three-launch chain: K3, K4, the
                split scan) and QUANT_PARAMS (the chain on int8 rows: K3
                rows, K5, the split scan, the dither drawn in the graph).
                Launches: each slot's kernels trees x 254, split_commit =
                trees x 255; the planes and resident models hash to
                ONE_KERNEL_MODEL_SHA256, the three-launch one to
                PLANES_MODEL_SHA256 and the quantized one to
                QUANT_MODEL_SHA256 (default sizes); valid AUC from
                ``predict`` of the one-kernel models equal to phase 3b's.
                Prints the wall per tree against phase 3b's, launches per
                split slot and per tree, the graph's capture ms and replay
                launches and the busy share of one profiled block; the
                split scan against torch's at the chain models' root and a
                deep leaf, timed, with K3's and K4's / K5's device ms
                under the loop's static plans and under plans sized by the
                segment's own count; then the split commit against its
                twin at a full-width state, timed (alone, with phases 3b
                and 3e and the chain's kernel checks: ``--fused-only``).
3e. mixed    -- categorical and EFB data through the device tree loop:
                200,000 rows of 28 HIGGS-like columns, a 4-category and a
                24-category column and three one-hot blocks that EFB
                bundles (MIXED_PARAMS, 63 leaves, 8 trees), fused against
                per iteration: byte-equal model strings with one-vs-rest
                and many-vs-many splits; split_scan and route_rows_cat
                launched; the categorical router against its twin over the
                training rows and a 65,536-row rung, timed.
3f. ranking  -- the ranking path: bench.py's MSLR-like workload
                (mslr_like: 2,270,000 rows x 137 features, ~120-document
                queries, five grades; the valid set the last ~10% of the
                queries), RANK_PARAMS (lambdarank, 255 leaves, 255 bins,
                learning rate 0.1, NDCG@10, blocks of 10) through ``train``
                for RANK_TREES fused trees: ``rank_lambdas`` launched once a
                tree, each tree one graph replay; the wall per tree with the
                first block and the graph capture apart, each knob's
                ``auto`` resolution, train NDCG@10; a second run's model
                byte-equal; RANK_PER_ITER_TREES trees per iteration with the
                valid set byte-equal to the first fused ones, the valid
                NDCG@10 after each. The lambda kernel against its twin
                (rows within LAMBDA_RTOL of their query's largest value) on
                all-tied, seeded and trained scores at this shape and on
                RANK_EXTRA_SIZES (5,000 and 1,100 documents: the global
                path; one document; all labels 0; weights, no norm, a
                truncation above and below the lengths), timed; the
                threefry bits and uniforms of rank_xendcg's draw bit-equal
                card vs host and XENDCG_TREES fused rank_xendcg trees
                (alone, with 3g: ``--rank-only``).
3g. objectives -- OBJECTIVES (L1, Huber, Fair, Quantile, MAPE, Poisson,
                Gamma, Tweedie, multiclassova, cross_entropy,
                cross_entropy_lambda) on OBJECTIVE_ROWS HIGGS-shaped rows
                with labels valid for each, OBJECTIVE_TREES trees of
                OBJECTIVE_LEAVES leaves on the card and on the host: fused,
                or per iteration with leaf renewal; splits that agree and
                the train metric within OBJECTIVE_METRIC_TOL.
3h. options  -- phase 3's data, 255 leaves, through the device tree loop
                in fused blocks, OPTIONS_TREES trees of each of (a)
                feature_fraction_bynode 0.5 + extra_trees, (b)
                OPTIONS_SETS interaction constraints + OPTIONS_CEGB +
                OPTIONS_FORCED forced splits (a JSON file the script
                writes into a temp dir), (c) GOSS with tpu_goss_compact on
                and off, (d) the forced splits alone at default knobs (the
                one-kernel split); launch counts zeroed just before each
                run and read just after; OPTIONS_PER_ITER_TREES trees per
                iteration byte-equal to the first fused ones for (a), (b)
                and (d); (d)'s trees carry the forced splits at their top
                three levels; (c) on vs off: the models byte-equal, and one
                tree on full-float32 gradients bit-equal on both loops
                (check_goss_compact_bits); each model's sha256 and wall
                per tree, and the steady wall of a second block. The node
                inputs kernel against its twin at F = 28 and 137 (and 137
                with NODE_MANY_SETS sets), the split scan with
                every node input live against find_best_split at the root
                and a deep leaf, the forced leaf's scan at each forced
                slot, the extended commit at COMMIT_FORCED_CASES; (a) and
                (b) card vs host at OPTIONS_HOST_ROWS rows (train logloss
                within OPTIONS_METRIC_TOL) (alone: ``--options-only``).
3i. monotone -- phase 3's data, 255 leaves: MONO_TREES fused trees of
                each of (a) intermediate and (b) advanced monotone
                constraints on MONO_COLUMNS (8 of the 28 columns, mixed
                signs) through the device tree loop (the chain; advanced
                launches mono_commit and mono_bounds each split), launch
                counts zeroed just before each run and read just after;
                MONO_PER_ITER_TREES trees per iteration byte-equal to the
                first fused ones; the steady wall of a second block; the
                monotonicity sweep (MONO_SWEEP_ROWS rows, each constrained
                column through its bins, predicted through the forest
                kernel: no step against the sign beyond MONO_SWEEP_TOL);
                the same for (e) intermediate and (f) advanced on the two
                MONO_PAIR_COLUMNS, where (f) must differ from (e), as (b)
                must equal (a); (c) DART (drop_rate 0.1, skip_drop 0) and
                (d) RF (bagging 0.7, feature_fraction 0.8),
                MONO_BOOST_TREES trees each per iteration with the valid
                set, valid AUC. mono_bounds and mono_commit against their
                twins at F = 28 and 137 (L = 63) and F = 28, L = 255 (a
                numerical winner, a categorical one, an invalid round),
                the extended commit under both methods (L = 63 and 255),
                the split scan with per-candidate bounds against
                find_best_split at the root and a deep leaf, and on each
                fused learner's state at its middle and last live slots
                the commit, mono_commit, mono_bounds and the scan, all bit
                for bit; (a)-(d) and (f) card vs host at MONO_HOST_ROWS
                rows (train logloss within OPTIONS_METRIC_TOL) (alone:
                ``--monotone-only``).
3j. linear,  -- phase 3's data, 255 leaves: (a) linear trees
    dense       (LINEAR_TREES per iteration with the valid set, at the
                default linear_lambda and at LINEAR_LAMBDA): the Gram
                kernel (csrc/linear_gram.cu) against its twin at the
                middle and the last fit (within its f32 summation bound,
                counts and fit_ok equal), the model's sha256 equal across
                two runs, the model read back from its text predicting the
                same, valid AUC above the plain GBDT's at the same trees,
                card vs host at LINEAR_HOST_ROWS rows; (b) the dense
                builder at max_bin 1023 (u16 bins) and at
                tree_builder=dense with 255 bins: DENSE_TREES fused trees
                through the device tree loop (launch counts zeroed just
                before and read just after), DENSE_PER_ITER_TREES per
                iteration with the valid set byte-equal to them (the
                device loop again, as ``train`` runs it on the card), a
                second block; a tree of the device loop equal field by
                field to the per-split host loop's on the card; the dense
                histogram
                and the row update (csrc/dense_histogram.cu), the split
                scan past 256 bins and the u16 router against their twins
                on seeded inputs and at the root and a deep leaf of the
                fused learners (alone: ``--linear-dense-only``).
3k. API and  -- phase 3's data, 255 leaves, the API's defaults (the
    online      one-kernel split): (a) ``cv``, 3 folds x 2 rounds at full
                size (wall a fold, mean valid AUC), then card vs host at
                ``--host-rows`` rows x 63 leaves (equal folds and fold
                trees, metric histories within API_CV_TOL); (b)
                ``LGBMClassifier``, API_FIT_ROUNDS fused rounds
                (predict_proba and feature_importances_ equal the
                booster's); (c) the ``reset_parameter`` schedule (each
                tree's shrinkage equals it); (d) ``refit`` of (b)'s model
                on the valid rows, card vs host within API_REFIT_RTOL, its
                sha256; (e) ``pred_contrib`` (row sums = raw scores within
                API_CONTRIB_TOL, host ms); (f) ``task=convert_model``
                compiled with g++ (= the f64 raw scores within
                API_CONVERT_TOL); (g) a PredictServer over (b)'s model with
                an online refit trainer, then a continue-mode one, while
                API_PREDICT_THREADS threads post /predict and
                API_INGEST_POSTS chunks arrive on /ingest: every answer
                equal to one published version's prediction, no failure,
                a gate verdict. Launch counts zeroed before each part and
                read after (alone: ``--api-online-only``).
3l. fleet    -- a model of ``--trees`` trees x 255 leaves on phase 3's
                rows, served by a fleet on the card. (a) The raw-threshold
                walk (``csrc/forest_predict.cu``'s ``forest_raw``) against
                its twin
                ``predict_raw_impl`` on the card: every RAW_EDGE_CASES pack
                (each missing type at its edges, categorical sets, 3
                classes, linear + NaN, a 254-round chain, a chain one
                round deeper than the forest kernel's shared memory holds
                (tables read from device memory), no splits, padded
                rounds and trees, 1000 columns read from device memory),
                the model read back from its text at 1, 64, 4096
                and 65,536 rows, and 3e's categorical, a 3g multiclass and
                a 3j linear model: bit-equal, linear leaves within
                SCORE_ATOL + SCORE_RTOL |b|; timed at 65,536 rows. (b) A
                trainer (PredictServer, continue-mode OnlineTrainer over a
                FleetStore, leased, seeded by a boot publish), a
                ReplicaWatcher replica in this process and a ``python -m
                lightgbm_tpu_torch task=serve fleet_role=replica
                fleet_url=<trainer>`` replica process: 4 /predict threads
                on the replicas, 8 x 1,024 labeled rows to /ingest (one
                chunk through a replica, forwarded): every answer equals
                one published version's scores (|diff| 0 against the twin
                on its text), each replica moves one version a publish,
                every dispatch either replica made in the window launched
                the raw walk (the in-process replica's counted on its
                dispatching threads, the process's from its /healthz
                before and after) and no call on the card in this
                process reaches the twin; /predict p50 / p99 before, during and
                after the promotion. Launch counts zeroed before (b) and
                read after. (c) Failover: the standby takes a closed
                primary's unreleased lease within two ttl with its
                watermark, win streak and buffer; the fenced primary's
                publish raises StaleLeaseError and reaches no replica. (d)
                Snapshot compaction: a cold boot from snapshot + tail
                holds the full replay's buffer (sha256) (alone:
                ``--fleet-only``).
3m. parallel -- the distributed learners (``tree_learner=data|feature|
                voting``, slice 19) at full width: phase 3's rows binned
                once and written as npz, rank processes of this script
                (``--parallel-rank``) in gloo groups of 2 and 4 on the one
                card (NCCL refuses two ranks on a device; the port's Comm
                stages card tensors through pinned host memory), per
                iteration with the valid set, PARALLEL_TREES trees a run:
                at D = 2 data with and without tpu_hist_scatter, feature,
                voting (top_k PARALLEL_TOP_K), int8 data, data again
                (sha256-equal); at D = 4 data. Every rank's model
                sha256-equal to the others', its launches of B1, B5 and B3
                (B2, B6 and B3 for int8) and none of B7, the valid AUC
                within PARALLEL_AUC_TOL of the serial per-iteration model
                (chain kernels) of the same run, the wall a tree beside
                serial's (ranks share one card: no scaling figure), the
                collective bytes a tree by the shapes and as counted. On
                1/64-grid L2 labels within 1/8 the first tree of data and
                of feature byte-equal to serial's; the D = 2 group on the
                card against itself on the host (``--host-rows`` rows x 3
                trees x 63 leaves, the first tree equal, train logloss
                within LOGLOSS_TOL); a sharded load of a 200,000-row CSV
                by the two ranks (bins equal to one rank's load of the
                whole file, the first data tree byte-equal to the serial
                one); which gloo collectives take card tensors (alone:
                ``--parallel-only``).
4. quantized -- the slice-3 path, the same data and trees with
                QUANT_PARAMS (int8 quantized gradients, bagging 0.8, column
                sampling 0.8) on the rows layout: the rows partition, the
                int8 histogram and the router must have run; the same
                per-tree checks (the int8 count channel = the in-bag rows);
                byte-equal determinism; card vs host on 200,000 rows with
                every split of the first tree equal; valid AUC within
                AUC_TOL of phase 3's at the same number of trees; at the
                default sizes the model string's sha256 must be
                QUANT_MODEL_SHA256. The rows partition (W = F + 3 and
                F + 12) and the int8 histogram against their twins on the
                2M root, the leaf nearest 64k rows and the leaf nearest 8k
                rows (ROWS_SEGMENTS), timed there by device time and the
                host clock (alone: ``--rows-only``).
5. short runs -- unquantized rows layout vs planes, 200,000 rows x 3
                trees on the card: byte-equal model strings (the rows
                histogram kernel must have run); GOSS on the card vs the
                host.
6. serve     -- the quantized model through every serving entry point:
                PredictSession requests of 1, 256, 4096 and 65536 rows, 64
                concurrent MicroBatcher submits, loopback ``POST /predict``
                and ``predict_binned`` over 2,000,000 binned rows, counts
                zeroed just before and read just after (forest and router
                must have run); every answer against the plain path and, on
                a small input, the host tree walk. The forest kernel
                bit-equal to its twin at FOREST_SHAPES (the 256, 4096 and
                65,536-row rungs, and a 40-tree chain forest of 254 rounds
                over the top rung), timed there by device time and the host
                clock, and the median PredictSession.predict latency per
                request size, before the serving entry points run and after
                their checks (alone: ``--forest-only``).
7. timings   -- each kernel's ms (CUDA events), its plain twin's ms, one
                library call's ms where torch has one, and its bound at the
                main path's shapes, beside the card's name and power limit;
                for the one-kernel split also the three-launch path's ms on
                the same 2M-row root split; the resident kernels at the 2M
                root and at a deep leaf of ~8k rows, beside the planes
                kernels on the same rows; the small kernels' device ms
                with the host's launch overhead hidden (device_ms); the
                one-kernel split's per-phase breakdown from its own
                %globaltimer stamps at the root, a ~64k-row leaf and the
                deep leaf, planes and resident (b7_breakdown; alone:
                ``--breakdown-only``); whether the card takes a cluster
                dimension with a cooperative launch (cluster_probe).

In the full run the host halves of the card-vs-host checks, the reading
of the profiler's traces and phase 2b's ``python -m`` subprocess run in
worker processes beside the card's phases (host_call, host_later); their
checks run, and print, before phase 7. The seeded data of phases 2b and
3f is made while nvcc builds the kernels (make_beside).

The second-to-last line of output is the ``kernels`` JSON object; the last
is ``{"ok": true, "device": {...}}``. Without a card, or outside the
checkout, the script exits non-zero and prints no result.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

HERE = os.path.dirname(os.path.abspath(__file__))

#: score tolerance kernel vs plain twin: f32 sums of up to 100 leaf
#: values, in one order in the kernel and possibly another in torch's
#: reductions, plus FMA contraction in the linear-leaf dot products
SCORE_RTOL = 1e-5
SCORE_ATOL = 1e-5

#: train logloss after 3 iterations, card vs host: the histogram sums run
#: in another order, so near-tie splits may flip between the two
LOGLOSS_TOL = 1e-3

#: published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32
#: operations/s outside the tensor cores (the routing work is scalar)
PEAK_BYTES_PER_S = 3.35e12
PEAK_SCALAR_OPS_PER_S = 67e12

HIGGS_FEATURES = 28
TRAIN_ROWS = 2_000_000
VALID_ROWS = 100_000
BINNED_ROWS = 2_000_000
REQUEST_ROWS = (1, 256, 4096, 65536)
#: tpu_split_kernel=off pins the three-launch split (on the card auto runs
#: the one-kernel split wherever it can), so phase 3 measures that path
TRAIN_PARAMS = {"objective": "binary", "max_bin": 255, "num_leaves": 255,
                "verbosity": -1, "tpu_split_kernel": "off"}
#: the slice-3 configuration: int8 quantized gradients, bagging and column
#: sampling on top of TRAIN_PARAMS (trains on the rows work layout)
QUANT_PARAMS = {"use_quantized_grad": True, "bagging_fraction": 0.8,
                "bagging_freq": 1, "feature_fraction": 0.8}
#: GOSS samples from iteration 1 / learning_rate on: 2 here
GOSS_PARAMS = {"data_sample_strategy": "goss", "learning_rate": 0.5}
#: valid AUC, quantized and sampled model vs the unquantized planes model
#: at the same number of trees
AUC_TOL = 0.01
#: sha256 of phase 4's model string at the default sizes (seed 0, 40
#: trees, 255 leaves, 2M + 100k rows), grown on the card
QUANT_MODEL_SHA256 = ("5f9a32c5a7ecb6d640f57d1200e85bdd"
                      "7fb5606fbd4b6617abed348ab69de7f3")
#: the same for phase 3's model (planes, three launches) and phase 3b's
#: (one kernel per split; phase 3c's resident model must equal it)
PLANES_MODEL_SHA256 = ("5cedd567e5520c91fee156e7cc1ad159"
                       "7d6aebe9ad8ea533b403e4a9433978ba")
ONE_KERNEL_MODEL_SHA256 = ("1aee18f809833f7915df283f37952069"
                           "0e9a291b592c6e85c12db03ee658686d")
#: the slice-4 configuration: one launch per split (planes layout)
ONE_KERNEL_PARAMS = {"tpu_split_kernel": "on"}
#: valid AUC, one-kernel model vs the three-launch planes model at the same
#: number of trees (the scan's sums run in another order, so near-tie
#: splits may differ)
ONE_KERNEL_AUC_TOL = 0.002
#: one-kernel split vs the torch scan on the same histograms: gains, sums
#: and outputs within SPLIT_ATOL + SPLIT_RTOL * |x| (the kernel's prefix
#: sums accumulate in double, torch's on the card in float in another
#: order); the integer fields must be equal wherever the torch scan's
#: winner beats its runner-up by more than that
SPLIT_RTOL = 1e-5
SPLIT_ATOL = 1e-5
#: the slice-5 configuration: the resident layout (the bins stay once in
#: the router's planes; the partition moves 17-byte slim rows), one launch
#: per split
RESIDENT_PARAMS = {"tpu_resident_state": "on", "tpu_split_kernel": "on"}
#: the split-scan cases of the one-kernel split (split_case); in "ties" the
#: tie is exact in both scans by construction, so the winner must be equal
SPLIT_CASES = ("numerical", "nan_left", "nan_right", "categorical_onehot",
               "categorical_mvm", "categorical_mvm_asc", "monotone_penalty",
               "monotone_shallow", "masked_fmask", "no_split", "nan_gains",
               "ties", "l1_clip", "path_smooth")
EXACT_TIE_CASES = ("ties",)
#: the row bound of the static plans in the kernel checks (the device tree
#: loop plans its launches once, for the root): a 2M-row root's, so that
#: every checked segment is a deep leaf of it
CHAIN_STATIC_ROWS = 2_000_000


#: the script's clock, started at its first line of output
_CLOCK = []


def log(msg):
    """Print a line; a phase's header also gets the seconds since the
    script's first line, so that the output shows where the time goes."""
    if not _CLOCK:
        _CLOCK.append(time.perf_counter())
    if msg.startswith("== phase"):
        msg = "%s [at %.1f s]" % (msg, time.perf_counter() - _CLOCK[0])
    print(msg, flush=True)


# --------------------------------------------------------------------- data

def higgs_like(rng, n):
    """(n, 28) rows shaped like UCI HIGGS: 21 low-level features (lepton
    and 4 jets: pT, eta, phi, jet b-tags on 3 levels; missing energy
    magnitude and phi) and 7 high-level masses. Quantised to 1/1024 so
    every value and bin midpoint is float32-exact (raw-threshold and BIN
    routing then agree on every row)."""
    import numpy as np
    cols = []

    def pt():
        return rng.lognormal(-0.1, 0.45, n)

    def eta():
        return rng.normal(0.0, 1.0, n)

    def phi():
        return rng.uniform(-1.74, 1.74, n)

    cols += [pt(), eta(), phi(), pt(), phi()]        # lepton, missing E
    for _ in range(4):                               # jets
        btag = rng.choice([0.0, 1.087, 2.173], size=n, p=[0.55, 0.25, 0.2])
        cols += [pt(), eta(), phi(), btag]
    for _ in range(7):                               # m_jj ... m_wwbb
        cols.append(rng.lognormal(0.0, 0.3, n))
    X = np.stack(cols, axis=1)
    return np.round(X * 1024.0) / 1024.0


def construct(X, params, reference=None):
    from lightgbm_tpu_torch import Dataset
    return Dataset(X, params=params, reference=reference).construct()


def bin_rows(ds, X):
    """Raw rows -> ((n, Fi) i32 bins, (n, Fi) f32 raw) in inner order."""
    import numpy as np
    Xr = np.ascontiguousarray(
        np.asarray(X, np.float32)[:, ds.used_feature_indices])
    bins = np.empty(Xr.shape, np.int32)
    for j in range(Xr.shape[1]):
        bins[:, j] = ds.bin_mappers[j].value_to_bin(Xr[:, j])
    return bins, Xr


def random_trees(ds, rng, num_trees, num_leaves, *, categorical=False,
                 linear=False, leaf_scale=0.05):
    """Seeded trees grown leaf-wise like the trainer's split logs: round
    r splits a uniformly drawn existing leaf on a random feature at one of
    its bin bounds (categorical features on a random subset of bins)."""
    import numpy as np
    from lightgbm_tpu_torch.ops.binning import BIN_CATEGORICAL
    from lightgbm_tpu_torch.tree import Tree

    B = int(ds.feature_num_bins().max())
    F = ds.num_features
    trees = []
    for _ in range(num_trees):
        R = num_leaves - 1
        split_leaf = np.array([rng.randint(0, r + 1) for r in range(R)])
        feat = rng.randint(0, F, R)
        sbin = np.zeros(R, np.int64)
        is_cat = np.zeros(R, bool)
        go_left = np.zeros((R, B), bool)
        for r in range(R):
            m = ds.bin_mappers[feat[r]]
            if m.bin_type == BIN_CATEGORICAL:
                if not categorical:
                    feat[r] = (feat[r] + 1) % F
                    m = ds.bin_mappers[feat[r]]
                else:
                    is_cat[r] = True
                    go_left[r, :m.num_bins] = rng.rand(m.num_bins) < 0.5
                    continue
            sbin[r] = rng.randint(0, max(1, m.num_bins - 1))
        ones = np.ones((R, 3))
        t = Tree.from_split_log(
            R, split_leaf, feat, sbin, rng.rand(R) < 0.5, np.ones(R),
            ones, ones, rng.normal(0.0, leaf_scale, num_leaves),
            bin_mappers=ds.bin_mappers,
            real_feature_index=ds.used_feature_indices,
            go_left_table=go_left, is_categorical=is_cat)
        if linear:
            num = [ds.used_feature_indices[j] for j in range(F)
                   if ds.bin_mappers[j].bin_type != BIN_CATEGORICAL]
            t.is_linear = True
            t.leaf_const = rng.normal(0.0, leaf_scale, num_leaves)
            for leaf in range(num_leaves):
                if rng.rand() < 0.2:
                    continue          # a leaf without a linear model
                k = rng.randint(1, 4)
                t.leaf_features[leaf] = np.sort(
                    rng.choice(num, size=k, replace=False)).astype(np.int64)
                t.leaf_coeff[leaf] = rng.normal(0.0, leaf_scale, k)
        trees.append(t)
    return trees


def check_scores(name, got, want):
    """max |got - want|; raises when beyond SCORE_ATOL + SCORE_RTOL|want|."""
    import numpy as np
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError("%s: shape %s != %s"
                             % (name, got.shape, want.shape))
    if not np.isfinite(got).all():
        raise AssertionError("%s: non-finite output" % name)
    err = np.abs(got - want)
    bad = err > SCORE_ATOL + SCORE_RTOL * np.abs(want)
    if bad.any():
        raise AssertionError("%s: %d/%d values off, max |diff| = %.3g"
                             % (name, int(bad.sum()), bad.size, err.max()))
    return float(err.max()) if err.size else 0.0


def id_diff(name, got, want):
    """max |got - want| over leaf ids; raises unless they are all equal."""
    import torch
    if got.shape != want.shape:
        raise AssertionError("%s: shape %s != %s"
                             % (name, tuple(got.shape), tuple(want.shape)))
    diff = (got.long() - want.long()).abs()
    if torch.count_nonzero(diff):
        raise AssertionError("%s: %d leaf ids differ"
                             % (name, int(torch.count_nonzero(diff))))
    return int(diff.max()) if diff.numel() else 0


def sync(dev):
    """Wait for the card (a fault in a kernel surfaces here)."""
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


#: the host seconds cuda_ms spends on one timing at most (past its first
#: call): a slow call (a plain twin at full width) is timed over fewer
#: calls, never fewer than 3
TIMING_BUDGET_S = 0.25


def cuda_ms(fn, iters=20, warmup=2):
    """Mean milliseconds per call of ``fn`` on the current stream, over
    ``iters`` calls or as many as TIMING_BUDGET_S holds (at least 3)."""
    import torch
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = time.perf_counter() - t0
    iters = max(3, min(iters, int(TIMING_BUDGET_S / max(one, 1e-9))))
    for _ in range(warmup - 1):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20, warmup=2):
    """Mean device milliseconds per call of ``fn`` with the host's launch
    overhead hidden: the calls are queued behind a sleep kernel long enough
    for the host to issue all of them, and CUDA events around the calls
    time them back to back on the stream."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0          # one call, host and device
    khz = getattr(torch.cuda.get_device_properties(0), "clock_rate", 0)
    rate = (khz or 2_000_000) * 1e3            # SM cycles per second
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * iters * host_s + 2e-3) * rate))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ phases

def phase_kernels(dev, seed):
    """Every forest branch and both router layouts, kernel vs plain."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.learner import route_layout
    from lightgbm_tpu_torch.ops.forest import (forest_pack,
                                               forest_predict_impl,
                                               forest_predict_plain,
                                               forest_walk)
    from lightgbm_tpu_torch.ops.predict import tree_to_bin_log
    from lightgbm_tpu_torch.ops.route import (build_route_table, route_rows,
                                              route_rows_plain)

    rng = np.random.RandomState(seed + 1)
    n = 3000
    X = np.round(rng.randn(n, 10) * 16) / 64.0
    Xnan = X.copy()
    Xnan[rng.rand(n, 10) < 0.15] = np.nan
    Xcat = X.copy()
    Xcat[:, 0] = rng.randint(0, 12, n)
    Xcat[:, 3] = rng.randint(0, 5, n)
    cases = {
        "numerical": (X, {}, {}),
        "nan_missing": (Xnan, {}, {}),
        "categorical": (Xcat, {"categorical_feature": "0,3"},
                        {"categorical": True}),
        "multiclass3": (X, {}, {"num_class": 3}),
        "linear": (X, {}, {"linear": True}),
        "linear_nan": (Xnan, {}, {"linear": True}),
    }
    errs = {}
    for name, (Xc, params, opt) in cases.items():
        ds = construct(Xc, dict(params, verbosity=-1))
        K = opt.get("num_class", 1)
        trees = random_trees(ds, rng, 8 * K + 3, 31,
                             categorical=opt.get("categorical", False),
                             linear=opt.get("linear", False))
        fp, has_cat, has_lin = forest_pack(trees, ds, num_class=K,
                                           device=dev)
        if has_cat != (name == "categorical") \
                or has_lin != name.startswith("linear"):
            raise AssertionError("%s: pack flags cat=%s linear=%s"
                                 % (name, has_cat, has_lin))
        b, xr = bin_rows(ds, Xc[:1000])
        bins = torch.from_numpy(b).to(dev)
        xd = torch.from_numpy(xr).to(dev)
        kw = dict(num_class=K, has_cat=has_cat, has_linear=has_lin)
        got = forest_predict_impl(bins, xd, fp, walk=forest_walk(fp), **kw)
        want = forest_predict_plain(bins, xd, fp, **kw)
        sync(dev)
        check = check_scores if K > 1 or has_lin else check_bits
        errs["forest/" + name] = check(
            "forest/" + name, got.cpu().numpy(), want.cpu().numpy())

    # router without bundles (dense) and with EFB bundle columns
    ids = rng.randint(0, 12, (n, 3))
    Xs = np.zeros((n, 36))
    for blk in range(3):
        Xs[np.arange(n), blk * 12 + ids[:, blk]] = rng.rand(n) + 0.5
    Xefb = np.concatenate([Xs, np.round(rng.randn(n, 2) * 16) / 64.0], 1)
    for name, Xc in (("dense", Xnan), ("efb_bundles", Xefb)):
        ds = construct(Xc, {"verbosity": -1})
        if (name == "efb_bundles") != ds.has_bundles:
            raise AssertionError("router/%s: has_bundles=%s"
                                 % (name, ds.has_bundles))
        bundle = None
        if ds.has_bundles:
            bundle = {k: torch.as_tensor(v).to(dev)
                      for k, v in ds.bundle_maps().items()}
        bt = route_layout(torch.as_tensor(ds.binned).to(dev))
        err = 0
        for tree in random_trees(ds, rng, 4, 63):
            lg = tree_to_bin_log(tree, ds, dev)
            table = build_route_table(lg, bundle)
            got = route_rows(bt, table, lg.num_splits)
            want = route_rows_plain(bt, table, lg.num_splits)
            sync(dev)
            err = max(err, id_diff("router/" + name, got, want))
        errs["router/" + name] = float(err)
        if name == "efb_bundles":
            # the partition on a bundle column of the EFB matrix
            bt_rows = torch.as_tensor(ds.binned)
            g = int(np.argmax([len(gr.feature_indices) for gr in ds.groups]))
            table = torch.as_tensor(
                rng.rand(int(ds.group_num_bins().max())) < 0.4)
            work = seeded_work(rng, bt_rows, dev)
            errs["partition/bundle_column"] = check_partition(
                "partition/bundle_column", work, [0, 128 + 7, n - 9, g],
                table.to(dev))
    errs.update(phase_segment_kernels(dev, rng))
    errs.update(phase_rows_kernels(dev, rng))
    return errs


def seeded_work(rng, bins, dev, guard=128):
    """(2, W, Npad) work pair: plane 0 packs ``bins`` (N, G) u8 with seeded
    g/h/cnt at lane guard + i, plane 1 is junk."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.ops.partition import pack_planes, planes_npad

    n, gcols = bins.shape
    ghc = np.stack([rng.randn(n) * 2, np.abs(rng.randn(n)) + 0.01,
                    np.ones(n)], axis=1).astype(np.float32)
    npad = planes_npad(n, guard)
    work = torch.as_tensor(rng.randint(0, 256, (2, gcols + 12, npad))
                           .astype(np.uint8))
    work[0, :, guard:guard + n] = pack_planes(bins, torch.as_tensor(ghc))
    return work.to(dev)


def check_partition(name, work, seg, table, rows=False):
    """Kernel (on a CUDA tensor) vs plain twin, planes or rows layout: the
    whole buffer and the left count must be equal. Returns 0.0."""
    import torch
    from lightgbm_tpu_torch.ops import partition as P

    kernel, plain = (P.partition_segment_rows, P.partition_segment_rows_plain) \
        if rows else (P.partition_segment, P.partition_segment_plain)
    a, b = work.clone(), work.clone()
    sg = torch.tensor(seg, dtype=torch.int32, device=work.device)
    lt_a = kernel(a, sg, table, max(seg[2], 1))
    lt_b = plain(b, sg, table)
    sync(work.device)
    if int(lt_a) != int(lt_b):
        raise AssertionError("%s: lt %d != %d" % (name, int(lt_a), int(lt_b)))
    if not torch.equal(a, b):
        raise AssertionError("%s: %d bytes differ" % (
            name, int(torch.count_nonzero(a != b))))
    return 0.0


def abs_work(work, num_feat, rows=False):
    """The work pair with |g| and |h| in place of g and h (for the per-bin
    sum of |x| that scales the histogram tolerance)."""
    from lightgbm_tpu_torch.ops.partition import (pack_planes, pack_rows,
                                                  unpack_ghc,
                                                  unpack_ghc_planes)

    w = work.clone()
    for p in (0, 1):
        if rows:
            ghc = unpack_ghc(w[p], num_feat).abs().nan_to_num(0.0)
            w[p] = pack_rows(w[p, :, :num_feat], ghc)
        else:
            ghc = unpack_ghc_planes(w[p], num_feat).abs().nan_to_num(0.0)
            w[p] = pack_planes(w[p, :num_feat].t(), ghc.t())
    return w


def check_histogram(name, work, seg, num_bins, num_feat, exact, rows=False):
    """Kernel vs plain twin, planes or rows layout: counts equal, g/h
    within the kernel's f32 summation bound of the twin's exact sum, the
    same bits run to run; on the rows layout also the same bits as the
    planes kernel on the same rows. Returns max |diff|."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as H

    kernel, plain = (H.segment_histogram_rows, H.segment_histogram_rows_plain) \
        if rows else (H.segment_histogram, H.segment_histogram_plain)
    sg = torch.tensor(seg, dtype=torch.int32, device=work.device)
    kw = dict(num_bins=num_bins, num_feat=num_feat, exact=exact)
    got = kernel(work, sg, cnt_bound=max(seg[2], 1), **kw)
    want = plain(work, sg, **kw)
    absum = plain(abs_work(work, num_feat, rows), sg, **kw)
    sync(work.device)
    if not torch.equal(got[..., 2], want[..., 2]):
        raise AssertionError("%s: count channel differs" % name)
    diff = (got - want).abs()
    bound = H.sum_error_bound(seg[2]) * absum
    if not torch.isfinite(got).all() or (diff > bound).any():
        raise AssertionError("%s: g/h off, max |diff| %.3g"
                             % (name, float(diff.max())))
    check_bound_invariant(name, lambda b: kernel(work, sg, cnt_bound=b, **kw),
                          got, seg[2])
    if rows:
        planes = work.transpose(1, 2).contiguous()
        other = H.segment_histogram(planes, sg, cnt_bound=max(seg[2], 1),
                                    **kw)
        if not torch.equal(got.view(torch.int32), other.view(torch.int32)):
            raise AssertionError("%s: rows and planes kernels differ" % name)
    return float(diff.max())


def check_bound_invariant(name, launch, got, cnt):
    """``launch(cnt_bound)`` with the row bound at the segment's count, 2x
    and 8x it, and at CHAIN_STATIC_ROWS (the segment as a deep leaf of a
    plan sized for a 2M-row root, as the device tree loop's are), must give
    ``got``'s bits: the f32 histograms' summation order depends on the rows
    alone, never on the grid a host bound sizes (and run to run)."""
    import torch
    for b in (max(cnt, 1), 2 * max(cnt, 1), 8 * max(cnt, 1),
              CHAIN_STATIC_ROWS):
        x = launch(b)
        if not torch.equal(got.view(torch.int32), x.view(torch.int32)):
            raise AssertionError("%s: not bit-equal with cnt_bound %d"
                                 % (name, b))


def check_histogram_q(name, work, seg, num_bins, num_feat, scale):
    """int8 kernel vs plain twin: byte-equal, and the same bytes run to
    run. Returns 0.0."""
    import torch
    from lightgbm_tpu_torch.ops.histogram import (segment_histogram_q,
                                                  segment_histogram_q_plain)

    sg = torch.tensor(seg, dtype=torch.int32, device=work.device)
    kw = dict(num_bins=num_bins, num_feat=num_feat)
    got = segment_histogram_q(work, sg, scale, cnt_bound=max(seg[2], 1), **kw)
    want = segment_histogram_q_plain(work, sg, scale, **kw)
    again = segment_histogram_q(work, sg, scale, cnt_bound=max(seg[2], 1),
                                **kw)
    sync(work.device)
    if not torch.isfinite(got).all() \
            or not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError("%s: %d values differ from the twin" % (
            name, int(torch.count_nonzero(got != want))))
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        raise AssertionError("%s: not byte-equal run to run" % name)
    return 0.0


def seeded_rows_work(rng, bins, dev, quantized=False, guard=128):
    """(2, Npad, W) rows pair: buffer 0 packs ``bins`` (N, G) u8 with seeded
    g/h/cnt at row guard + i (a fifth of the rows out of bag: g = h = cnt
    = 0), int8 with a seeded dither when ``quantized``; buffer 1 is junk.
    Returns (work, the (3,) dequantization scale or None)."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.ops.histogram import dequant_scale
    from lightgbm_tpu_torch.ops.partition import (pack_rows,
                                                  pack_rows_quantized,
                                                  planes_npad,
                                                  quantize_scales, work_spec)
    from lightgbm_tpu_torch.prng import PRNGKey

    n, gcols = bins.shape
    m = (rng.rand(n) < 0.8).astype(np.float32)
    ghc = torch.as_tensor(np.stack([rng.randn(n) * 2 * m,
                                    (np.abs(rng.randn(n)) + 0.01) * m, m],
                                   axis=1).astype(np.float32))
    _, width = work_spec(gcols, quantized)
    work = torch.as_tensor(rng.randint(0, 256, (2, planes_npad(n, guard),
                                                width)).astype(np.uint8))
    scale = None
    if quantized:
        scales = quantize_scales(ghc)
        work[0, guard:guard + n] = pack_rows_quantized(
            bins, ghc, PRNGKey(int(rng.randint(1 << 30))), scales)
        scale = dequant_scale(scales).to(dev)
    else:
        work[0, guard:guard + n] = pack_rows(bins, ghc)
    return work.to(dev), scale


#: (name, [src, start, cnt, feat], table) of the partition cases over a
#: 9000-row segment buffer: "table", all left ("all") or all right ("none")
PART_CASES = (("unaligned", [0, 128 + 13, 7001, 3], "table"),
              ("whole", [0, 128, 9000, 0], "table"),
              ("under_one_block", [0, 128 + 4095, 300, 5], "table"),
              ("empty_left", [0, 128 + 100, 777, 2], "none"),
              ("empty_right", [0, 128 + 100, 777, 2], "all"),
              ("one_row", [0, 128 + 8999, 1, 9], "table"))
#: (name, [plane, start, cnt]) of the histogram cases
HIST_CASES = (("whole", [0, 128, 9000]), ("unaligned", [0, 128 + 13, 7001]),
              ("one_row", [0, 128 + 77, 1]), ("empty", [0, 128 + 5, 0]))


def phase_segment_kernels(dev, rng):
    """Partition and segment histogram on the planes layout, kernel vs
    plain, small cases."""
    import numpy as np
    import torch

    n, nb = 9000, 64
    bins = torch.as_tensor(rng.randint(0, nb, (n, 10)).astype(np.uint8))
    work = seeded_work(rng, bins, dev)
    tables = _tables(rng, nb, dev)
    errs = {}
    for name, seg, tbl in PART_CASES:
        key = "partition/" + name
        errs[key] = check_partition(key, work, seg, tables[tbl])
    for exact in (True, False):
        for name, seg in HIST_CASES:
            key = "histogram/%s/%s" % ("hilo" if exact else "bf16", name)
            errs[key] = check_histogram(key, work, seg, nb, 10, exact)
    return errs


def _tables(rng, nb, dev):
    import torch
    none = torch.zeros(nb, dtype=torch.bool, device=dev)
    return {"table": torch.as_tensor(rng.rand(nb) < 0.45).to(dev),
            "none": none, "all": ~none}


def phase_rows_kernels(dev, rng):
    """The rows partition, the rows histogram and the int8 histogram,
    kernel vs plain, small cases: W = F + 12 and F + 3, F = 27 (its f32
    words start unaligned) and 28."""
    import numpy as np
    import torch

    n, nb = 9000, 64
    tables = _tables(rng, nb, dev)
    errs = {}
    for F, quantized in ((27, False), (28, True), (27, True)):
        bins = torch.as_tensor(rng.randint(0, nb, (n, F)).astype(np.uint8))
        work, scale = seeded_rows_work(rng, bins, dev, quantized)
        tag = "w%d" % work.shape[2]
        for name, seg, tbl in PART_CASES:
            key = "partition_rows/%s/%s" % (tag, name)
            errs[key] = check_partition(key, work, seg, tables[tbl],
                                        rows=True)
        if quantized:
            for name, seg in HIST_CASES:
                key = "histogram_q/%s/%s" % (tag, name)
                errs[key] = check_histogram_q(key, work, seg, nb, F, scale)
            continue
        for exact in (True, False):
            for name, seg in HIST_CASES:
                key = "histogram_rows/%s/%s/%s" % (
                    tag, "hilo" if exact else "bf16", name)
                errs[key] = check_histogram(key, work, seg, nb, F, exact,
                                            rows=True)
    return errs


def planes_pair(rng, W, npad, dev, nb=64):
    """A seeded (2, W, npad) u8 planes pair; its first 8 planes hold bins
    below ``nb`` (split columns for tables of ``nb`` bins)."""
    import numpy as np
    import torch
    work = rng.randint(0, 256, (2, W, npad)).astype(np.uint8)
    work[:, :min(W, 8)] %= nb
    return torch.as_tensor(work).to(dev)


def planes_edge_counts(W, sms, limits=True):
    """The counts at which K3 planes' launch changes shape at width W on
    ``sms`` SMs: 0, 1, 31, 4095 and 4097 rows, a full-size tile + 1 and,
    with ``limits``, the resident limit - 1, at it and + 1
    (ops/partition.partition_planes_plan)."""
    from lightgbm_tpu_torch.ops import partition as P
    big = P.partition_planes_plan(10 ** 8, W, sms)
    out = [0, 1, 31, 4095, 4097, big.tile_rows + 1]
    if limits:
        limit = sms * (P.PART_PLANES_SMEM_BYTES // (big.stripe * W)) \
            * big.tile_rows
        if not (P.partition_planes_plan(limit, W, sms).resident
                and not P.partition_planes_plan(limit + 1, W, sms).resident):
            raise AssertionError("W = %d: the resident limit is not %d"
                                 % (W, limit))
        out += [limit - 1, limit, limit + 1]
    return out


def route_table_np(rng, rounds, F, kind):
    """A numpy (rounds * TBL_W,) i32 router table: "chain" (round r splits
    leaf r, the newest right child: depth = rounds), "leaf_zero" (every
    round splits leaf 0), "tree" (round r splits one of the leaves 0..r,
    some rounds with a movable-missing bin) or "bundles" (a tree whose
    rounds half read bundle columns: slots outside a sub-feature's range go
    the way ``rest`` says, on both sides)."""
    import numpy as np
    t = np.zeros((rounds, 10), np.int64)
    t[:, 0] = rng.randint(0, F, rounds)
    t[:, 3] = -1
    t[:, 5] = 1
    if kind == "chain":
        t[:, 0] = np.arange(rounds) % F
        t[:, 1] = np.arange(rounds)
        t[:, 2] = rng.randint(0, 12, rounds)
    elif kind == "leaf_zero":
        t[:, 2] = rng.randint(150, 256, rounds)
    else:
        t[:, 1] = [rng.randint(0, r + 1) for r in range(rounds)]
        t[:, 2] = rng.randint(0, 40, rounds)
        miss = rng.rand(rounds) < 0.4
        t[miss, 3] = rng.randint(0, 40, int(miss.sum()))
        t[miss, 4] = rng.rand(int(miss.sum())) < 0.5
        if kind == "bundles":
            b = rng.rand(rounds) < 0.5
            k = int(b.sum())
            t[b, 5] = 0
            t[b, 6] = rng.randint(1, 20, k)
            t[b, 7] = rng.randint(0, 8, k)
            t[b, 8] = rng.randint(4, 24, k)
            t[b, 9] = rng.rand(k) < 0.5
            t[b, 2] = rng.randint(0, 20, k)
    return t.astype(np.int32).reshape(-1)


def padded_table(table, ns, rounds):
    """``table``'s first ns rounds, then rounds of split_leaf = 0 up to
    ``rounds``, as the learner pads a tree's unused rounds."""
    import numpy as np
    t = table.reshape(-1, 10)[:ns]
    pad = np.zeros((rounds - ns, 10), np.int32)
    pad[:, 0], pad[:, 2], pad[:, 5] = 1, 255, 1
    return np.concatenate([t, pad]).reshape(-1)


def check_route_kernel(name, bins_t, table, num_splits):
    """Router kernel (on a CUDA tensor) vs twin: leaf ids equal, and the
    same ids again. Returns 0.0."""
    import torch
    from lightgbm_tpu_torch.ops.route import route_rows, route_rows_plain
    dev = bins_t.device
    tb = torch.as_tensor(table).to(dev)
    ns = torch.tensor([num_splits], dtype=torch.int32, device=dev)
    got = route_rows(bins_t, tb, ns)
    again = route_rows(bins_t, tb, ns)
    want = route_rows_plain(bins_t, tb, ns)
    sync(dev)
    id_diff(name, got, want)
    if not torch.equal(got, again):
        raise AssertionError("%s: not equal run to run" % name)
    return 0.0


def phase_planes_route_kernels(dev, rng, full=True):
    """K3 planes and the row router against their twins on their edge
    cases. K3 at W = 17 and 40 from unaligned lanes: the counts where its
    launch changes shape (planes_edge_counts; the resident limits only
    when ``full``), all left, all right and alternating tables (runs
    whose end words are shared with the other side and the neighbouring
    tiles), buffer 1 as the source. The router over 28 columns (staged
    tiles), 136 (staged, fewer blocks an SM) and 3000 (bins read from
    device memory): a 254-round chain, a tree that always splits leaf 0,
    padded rounds past num_splits, num_splits 0 and past the table, bundle
    columns with out-of-range slots both ways and movable-missing bins,
    and, when ``full``, a 4000-round tree; over 200,064, 20,096 and 2048
    rows when ``full``, else over a few thousand (the host rehearsal)."""
    import torch
    from lightgbm_tpu_torch.learner import route_layout
    from lightgbm_tpu_torch.ops import partition as P

    sms = P.sm_count(dev.index) if dev.type == "cuda" else 132
    errs = {}
    tables = _tables(rng, 64, dev)
    tables["alternating"] = torch.arange(64, device=dev) % 2 == 0
    for W in (17, 40):
        counts = planes_edge_counts(W, sms, full)
        start = 128 + 13
        work = planes_pair(rng, W, P.planes_npad(start + max(counts) + 16),
                           dev)
        for cnt in counts:
            key = "planes/w%d/%d" % (W, cnt)
            errs[key] = check_partition(key, work, [0, start, cnt, cnt % 8],
                                        tables["table"])
        for name, tbl in tables.items():
            for src, st, cnt in ((0, 128 + 1, 5), (1, 128 + 6, 5000)):
                key = "planes/w%d/%s/src%d_%d" % (W, name, src, cnt)
                errs[key] = check_partition(key, work, [src, st, cnt, 2], tbl)
    import numpy as np
    sizes = ((28, 200_064), (136, 20_096), (3000, 2048)) if full \
        else ((28, 4096), (136, 2048), (3000, 256))
    for F, npad in sizes:
        bins = torch.as_tensor(rng.randint(0, 48, (npad, F))
                               .astype(np.uint8))
        bins[::5, :] = 60          # slots past every sub-feature's range
        bt = route_layout(bins.to(dev))
        cases = {"chain254": (route_table_np(rng, 254, F, "chain"), 254),
                 "leaf_zero": (route_table_np(rng, 60, F, "leaf_zero"), 60),
                 "tree": (route_table_np(rng, 254, F, "tree"), 254),
                 "bundles": (route_table_np(rng, 254, F, "bundles"), 254),
                 "padded": (padded_table(route_table_np(rng, 254, F, "tree"),
                                         37, 254), 37),
                 "no_splits": (route_table_np(rng, 30, F, "tree"), 0),
                 "past_rounds": (route_table_np(rng, 30, F, "tree"), 1000)}
        if full and F == 28:
            cases["rounds4000"] = (route_table_np(rng, 4000, F, "tree"),
                                   4000)
        for name, (tbl, ns) in cases.items():
            key = "route/f%d/%s" % (F, name)
            errs[key] = check_route_kernel(key, bt, tbl, ns)
    return errs


def higgs_signal(X):
    """The learnable signal of higgs_labels: the high-level masses and the
    lepton pT push toward "signal", as they do in HIGGS."""
    import numpy as np
    return 1.5 * np.log(X[:, 21:28]).mean(axis=1) + 0.6 * np.log(X[:, 0]) \
        - 0.4 * np.abs(X[:, 1]) + 0.3 * (X[:, 8] > 0) \
        - 0.2 * np.log(X[:, 3])


def higgs_labels(rng, X):
    """0/1 labels drawn from the logistic of higgs_signal."""
    import numpy as np
    s = higgs_signal(X)
    p = 1.0 / (1.0 + np.exp(-2.5 * s))
    return (rng.rand(len(X)) < p).astype(np.float64)


def training_data(seed, train_rows, valid_rows):
    """Seeded (X, y, X_valid, y_valid), Higgs-shaped."""
    import numpy as np
    rng = np.random.RandomState(seed)
    X = higgs_like(rng, train_rows + valid_rows)
    y = higgs_labels(rng, X)
    return X[:train_rows], y[:train_rows], X[train_rows:], y[train_rows:]


def train_params(dev, leaves, extra=None):
    return dict(TRAIN_PARAMS, num_leaves=leaves, device_type=dev.type,
                metric=["auc", "binary_logloss"], **(extra or {}))


def build_datasets(dev, data, leaves, extra=None):
    """The binned (train, valid) Datasets of a training phase (``train``
    re-bins a Dataset built with other params, so each phase builds its
    own)."""
    import lightgbm_tpu_torch as lgt
    X, y, Xv, yv = data
    t0 = time.perf_counter()
    train = lgt.Dataset(X, label=y, params=train_params(dev, leaves, extra))
    train.construct()
    valid = lgt.Dataset(Xv, label=yv, reference=train)
    valid.construct()
    log("train: binned %d + %d rows on the host in %.1f s"
        % (len(X), len(Xv), time.perf_counter() - t0))
    return train, valid


def phase_train(dev, datasets, trees, leaves, extra=None):
    """The training path: ``lightgbm_tpu_torch.train`` at full width with a
    valid set, ``extra`` params on TRAIN_PARAMS; every tree's segment
    counts checked against the router (all rows) and its histograms' count
    channel against the in-bag rows. Returns (booster, launch counts,
    summary dict)."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import kernels

    train, valid = datasets
    params = train_params(dev, leaves, extra)
    n = len(train.label)
    checked = []

    def check_tree(env):
        g = env.model.inner
        st = g.learner.last_stats
        ns = st["num_splits"]
        cnt = st["leaf_cnt"][:ns + 1].long()
        leaf = st["row_leaf"].long()
        routed = torch.bincount(leaf, minlength=ns + 1)
        inbag = torch.bincount(leaf, weights=g._inbag.double(),
                               minlength=ns + 1)
        hist = st["hist_cnt"][:ns + 1].double()
        if int(cnt.sum()) != n or not torch.equal(cnt, routed[:ns + 1]) \
                or not torch.equal(hist, inbag[:ns + 1]):
            raise AssertionError("tree %d: leaf segment counts disagree "
                                 "with the router or the histograms' "
                                 "in-bag counts" % env.iteration)
        checked.append(ns)
        sync(dev)
        stamps.append(time.perf_counter())

    evals = {}
    stamps = []
    sync(dev)
    kernels.reset_launch_counts()
    if dev.type == "cuda":
        kernels.start_timing()
    t0 = time.perf_counter()
    bst = lgt.train(params, train, trees, valid_sets=[valid],
                    callbacks=[check_tree, lgt.record_evaluation(evals)])
    sync(dev)
    wall = time.perf_counter() - t0
    dev_ms = kernels.stop_timing() if dev.type == "cuda" else {}
    counts = kernels.launch_counts()
    if len(checked) != trees:
        raise AssertionError("checked %d trees of %d" % (len(checked), trees))
    auc = evals["valid_0"]["auc"][-1]
    ll = evals["valid_0"]["binary_logloss"][-1]
    if not (np.isfinite(ll) and 0.5 < auc <= 1.0):
        raise AssertionError("valid auc %.4f logloss %.4f" % (auc, ll))
    import hashlib
    tree_ms = np.diff([t0] + stamps) * 1e3
    summary = dict(trees=trees, splits=int(sum(checked)), wall_s=wall,
                   steady_tree_ms=float(np.median(tree_ms[1:]))
                   if trees > 1 else float(tree_ms[0]),
                   valid_auc_by_tree=list(evals["valid_0"]["auc"]),
                   model_sha256=hashlib.sha256(
                       bst.model_to_string().encode()).hexdigest(),
                   wall_per_tree_ms=wall / trees * 1e3, valid_auc=auc,
                   valid_logloss=ll,
                   layout=bst.inner.learner._kw["work_layout"],
                   kernel_ms_per_tree={k: v / trees for k, v in dev_ms.items()
                                       if v})
    log("train %s: %d trees x %d leaves on %d rows (%s layout) in %.2f s "
        "(%.1f ms/tree), %d splits; valid auc %.5f logloss %.5f; "
        "launches %s" % (json.dumps(extra or {}), trees, leaves, n,
                         summary["layout"], wall, summary["wall_per_tree_ms"],
                         summary["splits"], auc, ll, counts))
    if dev_ms:
        log("train: device ms per tree %s" % ", ".join(
            "%s %.3f" % kv for kv in summary["kernel_ms_per_tree"].items()))
    return bst, counts, summary


def check_determinism(dev, train, leaves, iters=2, extra=None):
    """Two card runs of ``iters`` iterations: byte-equal model strings."""
    import lightgbm_tpu_torch as lgt
    params = train_params(dev, leaves, extra)
    a = lgt.train(params, train, iters).model_to_string()
    b = lgt.train(params, train, iters).model_to_string()
    if a != b:
        raise AssertionError("two runs gave different model strings")
    log("determinism %s: %d iterations twice, model strings byte-equal "
        "(%d bytes)" % (json.dumps(extra or {}), iters, len(a)))


#: kineto's chrome-trace categories of work on the device
DEVICE_TRACE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_device_ms(path):
    """Device milliseconds by name in a chrome trace that torch.profiler
    exported (its events of DEVICE_TRACE_CATS), for host_call."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    by_name = {}
    for ev in events:
        if ev.get("cat") in DEVICE_TRACE_CATS and "dur" in ev:
            by_name[ev["name"]] = (by_name.get(ev["name"], 0.0)
                                   + float(ev["dur"]) / 1e3)
    return by_name


def profile_iteration(dev, train, leaves, extra=None):
    """One boosting iteration (after a warm-up one) under torch.profiler:
    device time by kernel name and the device's busy share of the wall.
    Returns a dict, whose device_busy_ms and top are filled when the trace
    has been read (None when the profiler saw no device activity). The
    device's activity alone is traced, and the trace is written as it
    stands and read by a host worker (trace_device_ms through host_call):
    a per-iteration tree runs tens of thousands of torch ops, and
    torch.profiler's own reading of them (key_averages) took 13-40 s of
    the script's process an iteration."""
    import torch
    import lightgbm_tpu_torch as lgt
    from torch.profiler import ProfilerActivity, profile

    bst = lgt.Booster(train_params(dev, leaves, extra), train)
    bst.update()
    sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bst.update()
        sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    tmp = tempfile.mkdtemp(prefix="lgbt_trace_")
    path = os.path.join(tmp, "trace.json")
    prof.export_chrome_trace(path)
    del prof, bst
    out = dict(wall_ms=wall_ms)

    def check(by_name):
        shutil_rmtree(tmp)
        busy = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        log("profile %s: one iteration, wall %.1f ms, device busy %.1f ms "
            "(%.1f%%); top kernels %s"
            % (json.dumps(extra or {}), wall_ms, busy, 100.0 * busy / wall_ms,
               ", ".join("%s %.2f" % kv for kv in top)))
        out.update(device_busy_ms=busy if by_name else None, top=top)

    host_call(trace_device_ms, (path,), check)
    return out


def tree_splits(bst):
    """Each tree's splits in order, [(feature, threshold), ...] a tree."""
    return [[(int(t.split_feature[r]), float(t.threshold[r]))
             for r in range(t.num_internal)] for t in bst.inner.models]


def split_agreement(a_bst, b_bst):
    """(splits that agree, splits, (first tree's agreeing, its splits)):
    per tree, the splits equal in order up to the first difference. Each
    side is a Booster or its tree_splits."""
    agree = total = 0
    first = None
    a_trees, b_trees = (t if isinstance(t, list) else tree_splits(t)
                        for t in (a_bst, b_bst))
    for a, b in zip(a_trees, b_trees):
        total += max(len(a), len(b))
        same = 0
        for sa, sb in zip(a, b):
            if sa != sb:
                break
            same += 1
        agree += same
        if first is None:
            first = (same, max(len(a), len(b)))
    return agree, total, first


# ------------------------------------------------------- host reference runs

#: the host (``device_type=cpu``) trainings that the card-vs-host checks
#: hold the card against. In the full run they go to HOST_WORKERS worker
#: processes of one torch thread each, started after the build: a host run
#: is bound by one core (200,000 rows x 3 trees x 63 leaves took 6.5 s on
#: one thread and 8.7 s on eight, on an 8-core x86 host), so they overlap
#: the card's phases instead of holding them up. Each check runs when the
#: script collects its host run (await_host_checks, before the result
#: lines); a failed check fails the script there. Elsewhere (a phase alone,
#: the CPU tests) a host run and its check run in place.
HOST_WORKERS = 4
#: seconds the script waits for one host run it collects
HOST_RUN_TIMEOUT_S = 600
_HOST = {"pool": None, "pending": [], "started": []}


def _host_worker_init():
    """A host worker sees no card, runs one torch thread and yields the
    CPU to the script's own process (whose host clock times the card)."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    os.nice(10)
    import torch
    torch.set_num_threads(1)


def host_train(params, X, y, trees, forced=None):
    """``lightgbm_tpu_torch.train(params, Dataset(X, y), trees)`` on the
    host (``params`` name device_type cpu); ``forced`` is the text of the
    forced-splits file the params name, written anew here. Returns
    {"splits": tree_splits, "eval_train": bst.eval_train(), "seconds": the
    training's wall}."""
    import lightgbm_tpu_torch as lgt
    with tempfile.TemporaryDirectory(prefix="lgbt_host_") as tmp:
        if forced is not None:
            params = dict(params, forcedsplits_filename=os.path.join(
                tmp, "forced.json"))
            with open(params["forcedsplits_filename"], "w") as f:
                f.write(forced)
        ds = lgt.Dataset(X, label=y, params=params)
        t0 = time.perf_counter()
        bst = lgt.train(params, ds, trees)
        secs = time.perf_counter() - t0
        return dict(splits=tree_splits(bst), eval_train=bst.eval_train(),
                    seconds=secs)


def host_call(fn, args, check):
    """``check(fn(*args))``: ``fn`` in a host worker when the full run
    keeps its pool (the check then runs in await_host_checks), else here
    and now. ``fn`` must not touch the card."""
    pool = _HOST["pool"]
    if pool is None:
        check(fn(*args))
    else:
        _HOST["pending"].append((pool.apply_async(fn, args), check))


def host_later(pending, check):
    """``check(pending.get())`` for work already under way in a process of
    its own (``pending.get(timeout)`` waits for it): in await_host_checks
    when the full run keeps its pool, else here and now."""
    if _HOST["pool"] is None:
        check(pending.get(timeout=HOST_RUN_TIMEOUT_S))
    else:
        _HOST["pending"].append((pending, check))


def host_run(params, X, y, trees, check):
    """Train on the host (host_train, device_type cpu) and call
    ``check(result)`` (host_call)."""
    params = dict(params, device_type="cpu")
    forced = None
    if params.get("forcedsplits_filename"):
        with open(params["forcedsplits_filename"]) as f:
            forced = f.read()
    host_call(host_train, (params, X, y, trees, forced), check)


class Started:
    """A process started with Popen, as host_later's pending work:
    ``get(timeout)`` waits for it and returns (its exit code, its wall
    from start to exit); ``kill()`` stops it."""

    def __init__(self, proc):
        self.proc, self.t0, self.secs = proc, time.perf_counter(), None
        self._waiter = threading.Thread(target=self._wait, daemon=True)
        self._waiter.start()
        _HOST["started"].append(self)

    def _wait(self):
        self.proc.wait()
        self.secs = time.perf_counter() - self.t0

    def get(self, timeout=None):
        self._waiter.join(timeout)
        if self._waiter.is_alive():
            raise TimeoutError("pid %d still running after %s s"
                               % (self.proc.pid, timeout))
        if self in _HOST["started"]:
            _HOST["started"].remove(self)
        return self.proc.returncode, self.secs

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self._waiter.join()


#: results make_beside made ahead of the phases that use them, by key
_PREMADE = {}


def make_beside(jobs):
    """Start a thread that makes ``{key: (fn, *args)}`` into _PREMADE, one
    after another. Returns a function that waits for the thread, raises
    what a job raised, and returns the thread's seconds."""
    done = {}

    def work():
        t0 = time.perf_counter()
        try:
            for key, (fn, *args) in jobs.items():
                _PREMADE[key] = fn(*args)
        except BaseException as exc:          # raised again by wait()
            done["error"] = exc
        done["seconds"] = time.perf_counter() - t0

    thread = threading.Thread(target=work, daemon=True)
    thread.start()

    def wait():
        thread.join()
        if "error" in done:
            raise done["error"]
        return done["seconds"]
    return wait


def premade(key, fn, *args):
    """``fn(*args)``, or what make_beside made under ``key`` (taken
    once)."""
    if key in _PREMADE:
        return _PREMADE.pop(key)
    return fn(*args)


def start_host_pool(workers=HOST_WORKERS):
    """Start the full run's host workers (spawned: a forked child would
    inherit the parent's CUDA state)."""
    import multiprocessing
    _HOST["pool"] = multiprocessing.get_context("spawn").Pool(
        workers, initializer=_host_worker_init)


def await_host_checks():
    """Collect every host run sent to the workers, in order, and run its
    check. Returns the seconds waited."""
    t0 = time.perf_counter()
    while _HOST["pending"]:
        res, check = _HOST["pending"].pop(0)
        check(res.get(timeout=HOST_RUN_TIMEOUT_S))
    return time.perf_counter() - t0


def stop_host_pool():
    """Stop the host workers and every process started as Started,
    whether or not their results were collected."""
    pool, _HOST["pool"] = _HOST["pool"], None
    _HOST["pending"] = []
    started, _HOST["started"] = _HOST["started"], []
    for proc in started:
        proc.kill()
    if pool is not None:
        pool.terminate()
        pool.join()


def card_vs_host(dev, data, rows, leaves, iters=3, extra=None,
                 first_tree_equal=False):
    """The same small training on the card and on the host (plain twins,
    host_run): splits that agree (every split of the first tree when
    ``first_tree_equal``), and train logloss within LOGLOSS_TOL. Returns
    the comparison's dict, filled when the host run's check has run."""
    import lightgbm_tpu_torch as lgt
    X, y = data[0][:rows], data[1][:rows]
    params = dict(train_params(dev, leaves, extra), metric=["binary_logloss"])
    ds = lgt.Dataset(X, label=y, params=params)
    t0 = time.perf_counter()
    bst = lgt.train(params, ds, iters)
    ta = time.perf_counter() - t0
    card, la = tree_splits(bst), bst.eval_train()[0][2]
    del bst, ds
    out = {}

    def check(host):
        lh, th = host["eval_train"][0][2], host["seconds"]
        agree, total, first = split_agreement(card, host["splits"])
        log("card vs host %s: %d rows x %d iterations; %d of %d splits "
            "agree (in order, up to the first difference per tree; first "
            "tree %d of %d); train logloss card %.7f host %.7f; card %.1f "
            "s, host %.1f s"
            % (json.dumps(extra or {}), rows, iters, agree, total,
               first[0], first[1], la, lh, ta, th))
        if abs(la - lh) > LOGLOSS_TOL:
            raise AssertionError("train logloss card %.6f vs host %.6f"
                                 % (la, lh))
        if first_tree_equal and first[0] != first[1]:
            raise AssertionError("first tree: %d of %d splits agree" % first)
        out.update(splits_agree=agree, splits=total, first_tree=first,
                   logloss_card=la, logloss_host=lh)

    host_run(params, X, y, iters, check)
    return out


def rows_vs_planes(dev, data, rows, leaves, iters=3):
    """Unquantized training on the rows layout against the planes layout
    on the card: byte-equal model strings (the two layouts hold the same
    rows in the same order and their histogram kernels share one body).
    Launch counts are zeroed before the rows run and read after it."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import kernels
    X, y = data[0][:rows], data[1][:rows]
    ds = lgt.Dataset(X, label=y, params=train_params(dev, leaves))
    planes = lgt.train(train_params(dev, leaves), ds, iters)
    sync(dev)
    kernels.reset_launch_counts()
    rows_bst = lgt.train(train_params(dev, leaves,
                                      {"tpu_work_layout": "rows"}), ds, iters)
    sync(dev)
    counts = kernels.launch_counts()
    a, b = planes.model_to_string(), rows_bst.model_to_string()
    log("rows vs planes: %d rows x %d iterations, model strings %s (%d "
        "bytes); rows launches %s" % (rows, iters,
                                      "byte-equal" if a == b else "DIFFER",
                                      len(a), counts))
    if a != b:
        raise AssertionError("rows and planes layouts grew different models")
    for name in ("partition_segment_rows", "segment_histogram_rows"):
        if counts.get(name, 0) <= 0:
            raise AssertionError("the rows run never launched %s" % name)
    return counts


def check_quantized_model(bst, counts, summary, args):
    """Phase 4's checks beside phase_train's: the rows layout, launches of
    K3 rows, K5 and the router, and the model's sha256 (added to
    ``summary``), which at the script's default sizes must equal
    QUANT_MODEL_SHA256: the kernels may change how fast they run, never
    which model they grow."""
    if summary["layout"] != "rows":
        raise AssertionError("quantized training ran on the %s layout"
                             % summary["layout"])
    for name in ("partition_segment_rows", "segment_histogram_q",
                 "route_rows"):
        if counts.get(name, 0) <= 0:
            raise AssertionError("quantized training never launched %s"
                                 % name)
    check_model_sha("quantized", summary, args, QUANT_MODEL_SHA256)


def check_model_sha(name, summary, args, want):
    """At the script's default sizes a phase's model string must hash to
    ``want`` (phase_train puts the sha256 in ``summary``)."""
    sha = summary["model_sha256"]
    default = (args.seed, args.trees, args.leaves, args.train_rows,
               args.valid_rows) == (0, 40, 255, TRAIN_ROWS, VALID_ROWS)
    log("%s model sha256 %s (%s)" % (
        name, sha, "must be %s" % want if default
        else "not the default sizes: not compared"))
    if default and sha != want:
        raise AssertionError("%s model sha256 %s, not %s" % (name, sha, want))


def full_width_segment_kernels(bst, dev, errs):
    """Partition and histogram kernels vs their twins at the training
    shapes: the root segment of all rows, with the trained first tree's
    root split; then each kernel's ms, twin ms, library ms and bound."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.ops.histogram import segment_histogram_plain
    from lightgbm_tpu_torch.ops.partition import (partition_segment,
                                                  partition_segment_plain,
                                                  planes_npad, work_spec,
                                                  pack_planes_fold_root)

    g = bst.inner
    lrn = g.learner
    bins = lrn.bins
    n, F = bins.shape
    B = lrn.num_bin_hist
    grad, hess = g.objective.get_gradients(g.train_score.score)
    ghc = torch.stack([grad, hess, torch.ones_like(grad)], dim=1)
    guard, width = work_spec(F)
    work = torch.zeros((2, width, planes_npad(n, guard)), dtype=torch.uint8,
                       device=dev)
    pack_planes_fold_root(work, bins, ghc, guard, num_bins=B, exact=True)
    t0 = g.models[0]
    feat = g.train_set.inner_feature_index(int(t0.split_feature[0]))
    table = torch.arange(B, device=dev) <= int(t0.split_bin[0])
    seg = [0, guard, n, feat]
    errs["partition/full_width"] = check_partition(
        "partition/full_width", work, seg, table)
    for exact in (True, False):
        key = "histogram/%s/full_width" % ("hilo" if exact else "bf16")
        errs[key] = check_histogram(key, work, seg[:3], B, F, exact)
    rows = {}
    sg4 = torch.tensor(seg, dtype=torch.int32, device=dev)
    sg3 = sg4[:3].contiguous()
    from lightgbm_tpu_torch.ops.histogram import segment_histogram
    p_ms = cuda_ms(lambda: partition_segment(work, sg4, table, n))
    pp_ms = cuda_ms(lambda: partition_segment_plain(work, sg4, table),
                    iters=3, warmup=1)
    h_ms = cuda_ms(lambda: segment_histogram(work, sg3, num_bins=B,
                                             num_feat=F, cnt_bound=n))
    hp_ms = cuda_ms(lambda: segment_histogram_plain(work, sg3, num_bins=B,
                                                    num_feat=F),
                    iters=3, warmup=1)
    # library yardstick: one index_add_ over precomputed flat (f*B + bin)
    # indices and the rows' (g, h, cnt) repeated per feature; the timed
    # window holds the zeroed (F*B, 3) output and the index_add_ only
    idx = (bins.long() + torch.arange(F, device=dev) * B).t().reshape(-1)
    vals = ghc.repeat(F, 1)
    out = torch.zeros((F * B, 3), device=dev)
    l_ms = cuda_ms(lambda: out.zero_().index_add_(0, idx, vals))
    h_dev = device_ms(lambda: segment_histogram(work, sg3, num_bins=B,
                                                num_feat=F, cnt_bound=n))
    p_dev = device_ms(lambda: partition_segment(work, sg4, table, n))
    rows["partition_segment"] = dict(
        route="cuda", source="lightgbm_tpu_torch/csrc/partition_segment.cu",
        replaces="lightgbm_tpu/ops/partition.py:1249",
        max_abs_err=max(v for k, v in errs.items()
                        if k.startswith("partition/")),
        ms=p_ms, device_ms=p_dev, plain_ms=pp_ms, library_ms=None,
        bytes=2 * width * n, ops=n)
    rows["segment_histogram"] = dict(
        route="cuda", source="lightgbm_tpu_torch/csrc/segment_histogram.cu",
        replaces="lightgbm_tpu/ops/histogram.py:698",
        max_abs_err=max(v for k, v in errs.items()
                        if k.startswith("histogram/")),
        ms=h_ms, device_ms=h_dev, plain_ms=hp_ms, library_ms=l_ms,
        bytes=(F + 12) * n + F * B * 3 * 4, ops=n * F * 5)
    log("full width: partition %.4f ms (device %s, twin %.2f), histogram "
        "%.4f ms (device %s, twin %.2f, index_add_ %.4f) over %d rows x %d "
        "columns" % (p_ms, p_dev, pp_ms, h_ms, h_dev, hp_ms, l_ms, n, F))
    return rows


def rows_segment(bst, dev, idx, start=128):
    """The rows ``idx`` (ascending) of a quantized rows model's training
    set as one segment at row ``start`` of buffer 0, packed as its training
    packs them from the model's gradients and last in-bag mask: int8
    (W = F + 3, scales from these rows) and f32 (W = F + 12); buffer 1 is
    zeroed. The split is the one find_best_split takes on the segment's
    histogram. Returns (int8 pair, f32 pair, [0, start, m, col], go-left
    table, the (3,) dequantization scale, the segment's in-bag rows)."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.ops import partition as P
    from lightgbm_tpu_torch.ops.split import find_best_split
    from lightgbm_tpu_torch.prng import PRNGKey, fold_in

    g = bst.inner
    lrn = g.learner
    F = lrn.bins.shape[1]
    B = lrn.num_bin_hist
    m = int(idx.shape[0])
    grad, hess = g.objective.get_gradients(g.train_score.score)
    inbag = g._inbag
    ghc = torch.stack([grad * inbag, hess * inbag, inbag], dim=1)[idx]
    bins = lrn.bins[idx]
    npad = P.planes_npad(m + start, 128)
    scales = P.quantize_scales(ghc)
    qwork = torch.zeros((2, npad, F + P.GH_BYTES_Q), dtype=torch.uint8,
                        device=dev)
    qwork[0, start:start + m] = P.pack_rows_quantized(
        bins, ghc, fold_in(PRNGKey(0), 987123), scales,
        offset=lrn._kw["dither_offset"])
    fwork = torch.zeros((2, npad, F + P.GH_BYTES), dtype=torch.uint8,
                        device=dev)
    fwork[0, start:start + m] = P.pack_rows(bins, ghc)
    hist = H.segment_histogram_rows(
        fwork, torch.tensor([0, start, m], dtype=torch.int32, device=dev),
        num_bins=B, num_feat=F, cnt_bound=m)
    info = find_best_split(hist, torch.sum(ghc, dim=0), lrn.meta,
                           torch.ones(F, dtype=torch.bool, device=dev),
                           lrn.hp)
    return (qwork, fwork, [0, start, m, int(info.feature)],
            info.go_left.contiguous(), H.dequant_scale(scales),
            int(inbag[idx].sum()))


#: the segments K3 rows and K5 are held and timed on: the 2M-row root,
#: the first tree's leaf nearest 64k rows and its leaf nearest 8k rows
#: (deep_leaf_rows); the leaves start at unaligned rows, as they do inside
#: a tree
ROWS_SEGMENTS = (("root", None, 128), ("mid", 65536, 128 + 5),
                 ("deep", 8192, 128 + 13))


def full_width_rows_kernels(bst, dev, errs, timed=True):
    """The rows partition (K3 rows), the rows histogram and the int8
    histogram (K5) vs their twins at the quantized training's shapes: the
    root segment of all rows, the ~64k-row leaf and the deep leaf
    (ROWS_SEGMENTS), packed as that training packs them (int8, W = F + 3)
    and unquantized (W = F + 12), each routed by the split find_best_split
    takes on it; the rows histogram at the root. Then, when ``timed`` (on
    the card), each kernel's ms, twin ms, library ms and bound at the
    root, and K3 rows (both widths) and K5 by device time (device_ms) and
    by the host clock (cuda_ms) on all three segments."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.ops import partition as P

    lrn = bst.inner.learner
    n, F = lrn.bins.shape
    B = lrn.num_bin_hist
    segs = {}
    for tag, target, start in ROWS_SEGMENTS:
        if target is None:
            idx = torch.arange(n, device=dev)
        else:
            idx = deep_leaf_rows(bst, dev, target)[0]
        segs[tag] = rows_segment(bst, dev, idx, start)
        qwork, fwork, seg, table, scale, _ = segs[tag]
        for key, work in (("partition_rows/full_width_" + tag, qwork),
                          ("partition_rows/full_width_%s_w%d"
                           % (tag, fwork.shape[2]), fwork)):
            errs[key] = check_partition(key, work, seg, table, rows=True)
        key = "histogram_q/full_width_" + tag
        errs[key] = check_histogram_q(key, qwork, seg[:3], B, F, scale)
    qwork, fwork, seg, table, scale, inbag = segs["root"]
    errs["histogram_rows/full_width"] = check_histogram(
        "histogram_rows/full_width", fwork, seg[:3], B, F, True, rows=True)
    if not timed:
        return {}
    per_seg = {}
    for tag, (qw, fw, sg, tb, sc, ib) in segs.items():
        s4 = torch.tensor(sg, dtype=torch.int32, device=dev)
        s3 = s4[:3].contiguous()
        m = sg[2]
        fns = {"partition": lambda: P.partition_segment_rows(qw, s4, tb, m),
               "partition_w40":
                   lambda: P.partition_segment_rows(fw, s4, tb, m),
               "histogram_q": lambda: H.segment_histogram_q(
                   qw, s3, sc, num_bins=B, num_feat=F, cnt_bound=m)}
        per_seg[tag] = dict(rows=m, inbag=ib, start=sg[1])
        for kind, fn in fns.items():
            per_seg[tag][kind] = dict(ms=cuda_ms(fn), device_ms=device_ms(fn))
        v = per_seg[tag]
        log("rows kernels %s: %d rows (%d in bag) from row %d: K3 rows "
            "W = %d %.4f ms (device %.4f), W = %d %.4f ms (device %.4f); "
            "K5 %.4f ms (device %.4f); bounds %.5f, %.5f, %.5f ms (bytes)"
            % (tag, m, ib, sg[1], qw.shape[2], v["partition"]["ms"],
               v["partition"]["device_ms"], fw.shape[2],
               v["partition_w40"]["ms"], v["partition_w40"]["device_ms"],
               v["histogram_q"]["ms"], v["histogram_q"]["device_ms"],
               2 * qw.shape[2] * m / PEAK_BYTES_PER_S * 1e3,
               2 * fw.shape[2] * m / PEAK_BYTES_PER_S * 1e3,
               ((F + 3) * m + F * B * 3 * 4) / PEAK_BYTES_PER_S * 1e3))
    sg4 = torch.tensor(seg, dtype=torch.int32, device=dev)
    sg3 = sg4[:3].contiguous()
    pp_ms = cuda_ms(lambda: P.partition_segment_rows_plain(qwork, sg4, table),
                    iters=3, warmup=1)
    h_ms = cuda_ms(lambda: H.segment_histogram_rows(
        fwork, sg3, num_bins=B, num_feat=F, cnt_bound=n))
    hp_ms = cuda_ms(lambda: H.segment_histogram_rows_plain(
        fwork, sg3, num_bins=B, num_feat=F), iters=3, warmup=1)
    qp_ms = cuda_ms(lambda: H.segment_histogram_q_plain(
        qwork, sg3, scale, num_bins=B, num_feat=F), iters=3, warmup=1)
    # library yardsticks: one index_add_ over precomputed flat (f*B + bin)
    # indices with the rows' channels repeated per feature, f32 (g, h, cnt)
    # for the rows histogram, the int8 bytes as int32 for the int8 one
    rows0 = seg[1]
    idx = (lrn.bins.long() + torch.arange(F, device=dev) * B).t().reshape(-1)
    vals = P.unpack_ghc(fwork[0, rows0:rows0 + n], F).repeat(F, 1)
    out = torch.zeros((F * B, 3), device=dev)
    l_ms = cuda_ms(lambda: out.zero_().index_add_(0, idx, vals))
    gq, hq, cq = P.unpack_ghq(qwork[0, rows0:rows0 + n], F)
    qvals = torch.stack([gq.int(), hq.int(), cq.int()], dim=1).repeat(F, 1)
    qout = torch.zeros((F * B, 3), dtype=torch.int32, device=dev)
    lq_ms = cuda_ms(lambda: qout.zero_().index_add_(0, idx, qvals))
    h_dev = device_ms(lambda: H.segment_histogram_rows(
        fwork, sg3, num_bins=B, num_feat=F, cnt_bound=n))
    W = qwork.shape[2]
    root = per_seg["root"]

    def err(prefix):
        return max(v for k, v in errs.items() if k.startswith(prefix))

    def seg_times(kind):
        return {tag: dict(rows=v["rows"], **v[kind])
                for tag, v in per_seg.items()}

    rows = {
        "partition_segment_rows": dict(
            route="cuda",
            source="lightgbm_tpu_torch/csrc/partition_rows.cu",
            replaces="lightgbm_tpu/ops/partition.py:908",
            max_abs_err=err("partition_rows/"),
            ms=root["partition"]["ms"],
            device_ms=root["partition"]["device_ms"], plain_ms=pp_ms,
            library_ms=None, segments=seg_times("partition"),
            segments_w40=seg_times("partition_w40"),
            bytes=2 * W * n, ops=n),
        "segment_histogram_rows": dict(
            route="cuda",
            source="lightgbm_tpu_torch/csrc/segment_histogram.cu",
            replaces="lightgbm_tpu/ops/histogram.py:385",
            max_abs_err=err("histogram_rows/"), ms=h_ms, device_ms=h_dev,
            plain_ms=hp_ms, library_ms=l_ms,
            bytes=(F + 12) * n + F * B * 3 * 4,
            ops=n * F * 5),
        "segment_histogram_q": dict(
            route="cuda",
            source="lightgbm_tpu_torch/csrc/segment_histogram_q.cu",
            replaces="lightgbm_tpu/ops/histogram.py:891",
            max_abs_err=err("histogram_q/"), ms=root["histogram_q"]["ms"],
            device_ms=root["histogram_q"]["device_ms"], plain_ms=qp_ms,
            library_ms=lq_ms, segments=seg_times("histogram_q"),
            bytes=(F + 3) * n + F * B * 3 * 4, ops=inbag * F * 3),
    }
    log("full width rows: partition %.4f ms (twin %.2f) at W = %d, rows "
        "histogram %.4f ms (device %s, twin %.2f, index_add_ %.4f), int8 "
        "histogram %.4f ms (twin %.2f, int32 index_add_ %.4f) over %d rows "
        "x %d columns, %d in bag"
        % (root["partition"]["ms"], pp_ms, W, h_ms, h_dev, hp_ms, l_ms,
           root["histogram_q"]["ms"], qp_ms, lq_ms, n, F, inbag))
    return rows


#: the segments K3 planes (B1) is held and timed on: the phase-3 model's
#: 2M-row root, the first tree's leaf nearest 64k rows and its leaf
#: nearest 8k rows (deep_leaf_rows), all from unaligned lanes, as a
#: tree's leaves start
PLANES_SEGMENTS = (("root", None, 128 + 3), ("mid", 65536, 128 + 5),
                   ("deep", 8192, 128 + 13))


def full_width_planes(bst, dev, errs, timed=True):
    """K3 planes against its twin on PLANES_SEGMENTS of a planes model:
    each segment packed from the model's gradients on the planes pair
    (W = F + 12) and on the slim pair (W = RST_WIDTH, routed on its route
    plane, as the resident three-launch path runs it), split as
    find_best_split takes it (model_segment). Then, when ``timed`` (on
    the card), K3 at both widths on each segment by the host clock
    (cuda_ms) and by device time (device_ms), beside its bound. Returns
    {"w<W>": {segment: {rows, start, ms, device_ms, bound_ms}}}."""
    import torch
    from lightgbm_tpu_torch.ops import partition as P

    lrn = bst.inner.learner
    n, F = lrn.bins.shape
    res = lrn.bins_t.reshape(F, -1)
    out = {}
    for tag, target, start in PLANES_SEGMENTS:
        if target is None:
            idx, depth = torch.arange(n, device=dev), 1
        else:
            idx, depth = deep_leaf_rows(bst, dev, target)
        slim, planes, seg, table, _ = model_segment(bst, dev, idx, depth,
                                                    start)
        m = int(idx.shape[0])
        P.write_route_plane(slim, res, torch.tensor(
            seg, dtype=torch.int32, device=dev), m)
        cases = ((planes, seg), (slim, seg[:3] + [0]))
        for work, sg in cases:
            key = "partition/full_width_%s_w%d" % (tag, work.shape[1])
            errs[key] = check_partition(key, work, sg, table)
        if not timed:
            continue
        for work, sg in cases:
            s4 = torch.tensor(sg, dtype=torch.int32, device=dev)

            def fn():
                return P.partition_segment(work, s4, table, m)
            W = work.shape[1]
            v = dict(rows=m, start=start, ms=cuda_ms(fn),
                     device_ms=device_ms(fn),
                     bound_ms=2 * W * m / PEAK_BYTES_PER_S * 1e3)
            out.setdefault("w%d" % W, {})[tag] = v
            log("K3 planes %s: %d rows from lane %d, W = %d: %.4f ms "
                "(device %.4f), bound %.5f ms (bytes)"
                % (tag, m, start, W, v["ms"], v["device_ms"], v["bound_ms"]))
    return out


def chain_table(F, rounds, dev):
    """The (rounds * TBL_W,) i32 route table of a chain tree: round r
    splits leaf r, the newest right child, on column r % F. Rows go right
    (threshold bin -1) but on every 32nd round, where rows of bin 0 go
    left, so most rows walk every round: the router's worst case."""
    import torch
    from lightgbm_tpu_torch.ops.route import TBL_W

    tbl = torch.zeros((rounds, TBL_W), dtype=torch.int32)
    r = torch.arange(rounds, dtype=torch.int32)
    tbl[:, 0] = r % F
    tbl[:, 1] = r
    tbl[:, 2] = torch.where(r % 32 == 31, 0, -1)
    tbl[:, 3] = -1
    tbl[:, 5] = 1
    return tbl.reshape(-1).to(dev)


def full_width_route(bst, valid, dev, errs, timed=True):
    """The row router against its twin (leaf ids equal) at the shapes the
    main path gives it, with the first tree of the planes model ``bst``:
    its 2M training rows, the valid set ``valid`` (a BinnedDataset), a
    65,536-row serving rung (the valid set's first rows) and a chain tree
    of as many rounds over the training rows (chain_table). Then, when
    ``timed`` (on the card), each by the host clock (cuda_ms) and by
    device time (device_ms), beside its bound (the bins read once, the
    table, the ids written). Returns {shape: {rows, ms, device_ms,
    bound_ms}}."""
    import torch
    from lightgbm_tpu_torch.learner import route_layout
    from lightgbm_tpu_torch.ops.predict import tree_to_bin_log
    from lightgbm_tpu_torch.ops.route import (build_route_table, route_rows,
                                              route_rows_plain)

    g = bst.inner
    lrn = g.learner
    n, F = lrn.bins.shape
    t0 = g.models[0]
    lg = tree_to_bin_log(t0, g.train_set, dev)
    vlg = tree_to_bin_log(t0, valid, dev)
    table = build_route_table(lg, None)
    vtable = build_route_table(vlg, None)
    vbins = g._valid_bins(valid)
    rounds = table.numel() // 10        # the model's num_leaves - 1
    chain_ns = torch.full((1,), rounds, dtype=torch.int32, device=dev)
    shapes = {
        "train": (lrn.bins_t, table, lg.num_splits, n),
        "valid": (g._valid_bins_t(valid), vtable, vlg.num_splits,
                  valid.num_data),
        "serve": (route_layout(vbins[:65536]), vtable, vlg.num_splits,
                  min(65536, valid.num_data)),
        "chain": (lrn.bins_t, chain_table(F, rounds, dev), chain_ns, n)}
    out = {}
    for tag, (bt, tb, ns, rows) in shapes.items():
        got = route_rows(bt, tb, ns)
        want = route_rows_plain(bt, tb, ns)
        sync(dev)
        errs["router/full_width_" + tag] = float(
            id_diff("router/full_width_" + tag, got, want))
        if not timed:
            continue

        def fn():
            return route_rows(bt, tb, ns)
        v = dict(rows=rows, ms=cuda_ms(fn), device_ms=device_ms(fn),
                 bound_ms=(bt.numel() + tb.numel() * 4 + bt.shape[1] * 512)
                 / PEAK_BYTES_PER_S * 1e3)
        out[tag] = v
        log("router %s: %d rows x %d columns, %d rounds: %.4f ms (device "
            "%.4f), bound %.5f ms (bytes); %d distinct leaves"
            % (tag, rows, bt.shape[0], tb.numel() // 10, v["ms"],
               v["device_ms"], v["bound_ms"], int(got[:rows].unique().numel())))
    return out


#: B8's shapes (full_width_forest): the serving rungs that requests of 1
#: or 256 rows (both one 256-row dispatch), 4096 and 65,536 rows
#: dispatch, with the serving model; and a chain forest over the top rung
FOREST_SHAPES = (("rung256", 256), ("rung4096", 4096),
                 ("rung65536", 65536), ("chain", 65536))


#: synthetic packs that stress the forest kernel's walk (forest_edge_pack),
#: and the row counts each is checked at (one pass, a pass's edges, a
#: ragged last pass of a multi-chunk launch); the WIDE ones have too many
#: features for a pass's bins to fit beside the tables, so their walks
#: read the bins from device memory (the plan's unstaged kernels)
FOREST_WIDE_CASES = ("wide", "wide_categorical")
FOREST_EDGE_CASES = ("chain254", "leaf_zero", "padded_rounds", "no_splits",
                     "past_rounds", "padded_trees", "nan_missing",
                     "categorical", "multiclass3", "linear_nan") \
    + FOREST_WIDE_CASES
#: features of a WIDE case's rows
FOREST_WIDE_F = 1000
FOREST_EDGE_ROWS = (1, 255, 257, 4097)


def forest_edge_pack(name, rng, n, dev, F=7, nb=48):
    """A seeded ForestPack that stresses one edge of the forest walk, with
    (n, F) i32 bins in [0, nb) (and raw rows for linear leaves). Returns
    (pack, bins, X or None, forest_predict kwargs). Cases: a 254-round
    chain (round r splits slot r; rows go right but at every 32nd round);
    trees that always split slot 0; padded rounds (num_splits below R,
    the rest slot 0 with junk); num_splits 0 (half the trees) and past R;
    11 trees padded to 16 with num_splits 0, as forest_pack pads; movable
    missing bins (15% of bins are the missing bin); categorical rounds;
    3 classes; linear leaves with NaN raw values; FOREST_WIDE_F features
    at 254 rounds, without and with categorical rounds. The 3 classes
    have 40 trees: two spans of groups, the last one short."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.ops.forest import ForestPack

    T, R, K, Km, Kc = 16, 62, 1, 1, 1
    if name in ("chain254", "padded_rounds") + FOREST_WIDE_CASES:
        R = 254
    if name in FOREST_WIDE_CASES:
        F = FOREST_WIDE_F
    if name in ("chain254", "leaf_zero", "no_splits", "past_rounds"):
        T = 8
    if name == "multiclass3":
        T, K = 40, 3
    if name == "linear_nan":
        Km = 3
    slot = np.array([[rng.randint(0, r + 1) for r in range(R)]
                     for _ in range(T)], np.int32)
    feature = rng.randint(0, F, (T, R)).astype(np.int32)
    tbin = rng.randint(0, nb, (T, R)).astype(np.int32)
    kind = np.zeros((T, R), np.int32)
    default_left = (rng.rand(T, R) < 0.5).astype(np.int32)
    miss_bin = np.zeros((T, R), np.int32)
    movable = np.zeros((T, R), np.int32)
    ns = np.full(T, R, np.int32)
    cat_bins = np.full((T, R, Kc), -2, np.int32)
    bins = rng.randint(0, nb, (n, F)).astype(np.int32)
    if name == "chain254":
        slot[:] = np.arange(R)
        tbin[:] = np.where(np.arange(R) % 32 == 31,
                           rng.randint(0, 4, (T, R)), -1)
    elif name == "leaf_zero":
        slot[:] = 0
        tbin[:] = rng.randint(nb // 2, nb, (T, R))
    elif name == "padded_rounds":
        ns[:] = rng.randint(1, R, T)
        pad = np.arange(R)[None, :] >= ns[:, None]
        slot[pad], feature[pad], tbin[pad] = 0, 1, 255
    elif name == "no_splits":
        ns[::2] = 0
    elif name == "past_rounds":
        ns[:] = 1000
    elif name == "padded_trees":
        ns[11:] = 0
    elif name == "nan_missing":
        movable[:] = rng.rand(T, R) < 0.4
        miss_bin[:] = np.where(rng.rand(T, R) < 0.7, nb - 1,
                               rng.randint(0, nb, (T, R)))
        bins[rng.rand(n, F) < 0.15] = nb - 1
    elif name in ("categorical", "wide_categorical"):
        Kc = 6
        kind[:] = rng.rand(T, R) < 0.3
        cat_bins = np.full((T, R, Kc), -2, np.int32)
        for t, r in zip(*np.nonzero(kind)):
            k = rng.randint(0, Kc + 1)
            cat_bins[t, r, :k] = rng.choice(nb, k, replace=False)
    L = R + 1
    value = rng.normal(0.0, 0.05, (T, L)).astype(np.float32)
    if name == "padded_trees":
        value[11:] = 0.0
    const = np.zeros((T, L), np.float32)
    coeff = np.zeros((T, L, Km), np.float32)
    coeff_feat = np.zeros((T, L, Km), np.int32)
    coeff_mask = np.zeros((T, L, Km), np.float32)
    X = None
    if name == "linear_nan":
        const[:] = rng.normal(0.0, 0.05, (T, L))
        coeff[:] = rng.normal(0.0, 0.05, (T, L, Km))
        coeff_feat[:] = rng.randint(0, F, (T, L, Km))
        coeff_mask[:] = rng.rand(T, L, Km) < 0.7
        Xn = rng.normal(0.0, 1.0, (n, F)).astype(np.float32)
        Xn[rng.rand(n, F) < 0.15] = np.nan
        X = torch.from_numpy(Xn).to(dev)

    def dev_t(a, tr=True):
        a = np.ascontiguousarray(np.swapaxes(a, 0, 1) if tr else a)
        return torch.from_numpy(a).to(dev)

    fp = ForestPack(
        slot=dev_t(slot), feature=dev_t(feature), tbin=dev_t(tbin),
        kind=dev_t(kind), default_left=dev_t(default_left),
        miss_bin=dev_t(miss_bin), movable=dev_t(movable),
        num_splits=dev_t(ns, False), value_of_slot=dev_t(value, False),
        tree_class=dev_t(np.arange(T, dtype=np.int32) % K, False),
        cat_bins=dev_t(cat_bins), const_of_slot=dev_t(const, False),
        coeff=dev_t(coeff, False), coeff_feat=dev_t(coeff_feat, False),
        coeff_mask=dev_t(coeff_mask, False))
    kw = dict(num_class=K, has_cat=name.endswith("categorical"),
              has_linear=name == "linear_nan")
    return fp, torch.from_numpy(bins).to(dev), X, kw


def phase_forest_kernels(dev, rng):
    """The forest kernel against its twin on every FOREST_EDGE_CASES pack
    at FOREST_EDGE_ROWS rows (each launch with the pack's forest_walk):
    bit-equal for one class without linear leaves, else within
    SCORE_ATOL + SCORE_RTOL * |b|. The WIDE packs' plans must read the
    bins from device memory, and only theirs."""
    from lightgbm_tpu_torch.ops.forest import (forest_plan,
                                               forest_predict_impl,
                                               forest_predict_plain,
                                               forest_walk)
    errs = {}
    for name in FOREST_EDGE_CASES:
        fp, bins, X, kw = forest_edge_pack(name, rng, max(FOREST_EDGE_ROWS),
                                           dev)
        walk = forest_walk(fp)
        exact = kw["num_class"] == 1 and not kw["has_linear"]
        R, T = fp.slot.shape
        # staging depends on rounds and features only, not on the SMs
        staged = forest_plan(1, T, R, 1, bins.shape[1],
                             kw["num_class"]).staged
        if staged == (name in FOREST_WIDE_CASES):
            raise AssertionError("forest_edge/%s: plan staged=%s"
                                 % (name, staged))
        for n in FOREST_EDGE_ROWS:
            xn = X[:n] if X is not None else None
            got = forest_predict_impl(bins[:n], xn, fp, walk=walk, **kw)
            want = forest_predict_plain(bins[:n], xn, fp, **kw)
            sync(dev)
            key = "forest_edge/%s/%d" % (name, n)
            errs[key] = (check_bits if exact else check_scores)(
                key, got.cpu().numpy(), want.cpu().numpy())
    return errs


def check_bits(name, got, want):
    """max |got - want|; raises unless the two f32 arrays are equal bit
    for bit (the kernel sums in its twin's order)."""
    import numpy as np
    got = np.ascontiguousarray(got, np.float32)
    want = np.ascontiguousarray(want, np.float32)
    err = check_scores(name, got, want)
    if got.tobytes() != want.tobytes():
        raise AssertionError("%s: %d/%d values differ in their bits "
                             "(max |diff| %.3g)"
                             % (name, int((got.view(np.int32)
                                           != want.view(np.int32)).sum()),
                                got.size, err))
    return err


def chain_trees(ds, rng, num_trees, rounds):
    """``num_trees`` chain trees of ``rounds`` rounds over the features of
    ``ds``: round r splits leaf r (the newest right child) at bin 0 of a
    feature with at least 64 bins, so a row goes left, and stops, only
    where its bin is 0 (~1 row in 255): most rows walk most of the rounds,
    the forest walk's worst case."""
    import numpy as np
    from lightgbm_tpu_torch.tree import Tree

    wide = [j for j in range(ds.num_features)
            if ds.bin_mappers[j].num_bins >= 64]
    trees = []
    for _ in range(num_trees):
        ones = np.ones((rounds, 3))
        trees.append(Tree.from_split_log(
            rounds, np.arange(rounds),
            np.array([wide[r % len(wide)] for r in range(rounds)]),
            np.zeros(rounds, np.int64), rng.rand(rounds) < 0.5,
            np.ones(rounds), ones, ones,
            rng.normal(0.0, 0.05, rounds + 1),
            bin_mappers=ds.bin_mappers,
            real_feature_index=ds.used_feature_indices))
    return trees


def forest_walk_steps(trees, pack, bins, has_cat):
    """Links a walk along child links follows for the (n, F) i32 ``bins``
    through ``trees`` (packed as ``pack``): the depth of each row's leaf
    (its slot from forest_slots_plain), summed over rows and trees."""
    import torch
    from lightgbm_tpu_torch.ops.forest import forest_slots_plain

    slots = forest_slots_plain(bins, pack, has_cat).long()
    steps = 0
    for t, tree in enumerate(trees):
        leaf_of_slot = tree.to_split_arrays()["leaf_of_slot"]
        depth = torch.as_tensor(tree.leaf_depths()[leaf_of_slot])
        steps += int(depth.to(bins.device)[slots[t]].sum())
    return steps


def forest_bound_bytes(pack, walk, bins, num_class=1, has_cat=False,
                       has_linear=False):
    """Bytes one forest call must move: the (n, F) i32 bins (and raw rows
    for linear leaves) read once, the tables the kernel reads for this
    pack (its 16-byte walk entries, first rounds, leaf values and tree
    classes; the categorical bins only with categorical rounds, the
    linear tables only with linear leaves) read once, and the (n, K) f32
    scores written once."""
    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    b = nbytes(bins, walk.nodes, walk.first, pack.value_of_slot,
               pack.tree_class) + bins.shape[0] * max(1, num_class) * 4
    if has_cat:
        b += nbytes(pack.cat_bins)
    if has_linear:
        b += nbytes(bins, pack.const_of_slot, pack.coeff, pack.coeff_feat,
                    pack.coeff_mask)
    return b


def full_width_forest(bst, reqs, dev, errs, timed=True, seed=0):
    """The forest kernel against its twin (bit-equal: K = 1) at
    FOREST_SHAPES, with the serving model ``bst`` (its cached forest
    entry, as PredictSession dispatches it) on the bins of ``reqs`` (rows
    -> raw requests), and with a chain forest of as many trees and rounds
    (chain_trees) over the top rung. Then, when ``timed`` (on the card),
    each by the host clock (cuda_ms) and by device time (device_ms),
    beside its bound: the bytes of forest_bound_bytes over 3.35 TB/s, or
    two operations a walk step and one a tree over 67 TFLOP/s, whichever
    is larger. Returns {shape: {rows, steps, ms, device_ms, bound_ms,
    bound_by}}."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.ops.forest import (forest_pack,
                                               forest_predict_impl,
                                               forest_predict_plain,
                                               forest_walk)

    g = bst.inner
    ds = g.train_set
    fp, has_cat, has_lin, walk = g._forest_model(0, len(g.models))
    rounds = fp.slot.shape[0]
    chain = chain_trees(ds, np.random.RandomState(seed + 13),
                        len(g.models), rounds)
    cfp = forest_pack(chain, ds, device=dev)[0]
    forests = {"serve": (fp, walk, g.models, has_cat),
               "chain": (cfp, forest_walk(cfp), chain, False)}
    out = {}
    for tag, rows in FOREST_SHAPES:
        pack, pw, trees, cat = forests["chain" if tag == "chain"
                                       else "serve"]
        b, _ = bin_rows(ds, reqs[rows])
        bins = torch.from_numpy(b).to(dev)
        got = forest_predict_impl(bins, None, pack, walk=pw, has_cat=cat)
        want = forest_predict_plain(bins, None, pack, has_cat=cat)
        sync(dev)
        errs["forest/full_width_" + tag] = check_bits(
            "forest/full_width_" + tag, got.cpu().numpy(),
            want.cpu().numpy())
        steps = forest_walk_steps(trees, pack, bins, cat)
        v = dict(rows=rows, trees=len(trees), steps=steps,
                 bytes=forest_bound_bytes(pack, pw, bins, has_cat=cat),
                 ops=2 * steps + len(trees) * rows)
        if timed:
            def fn():
                return forest_predict_impl(bins, None, pack, walk=pw,
                                           has_cat=cat)
            t_bytes = v["bytes"] / PEAK_BYTES_PER_S * 1e3
            t_ops = v["ops"] / PEAK_SCALAR_OPS_PER_S * 1e3
            v.update(ms=cuda_ms(fn), device_ms=device_ms(fn),
                     bound_ms=max(t_bytes, t_ops),
                     bound_by="bytes" if t_bytes >= t_ops else "operations")
            log("forest %s: %d rows x %d trees, %d rounds, %d walk steps: "
                "%.4f ms (device %.4f), bound %.5f ms (%s)"
                % (tag, rows, len(trees), rounds, steps, v["ms"],
                   v["device_ms"], v["bound_ms"], v["bound_by"]))
        out[tag] = v
    return out


def serve_latency(bst, reqs, reps=5):
    """Median host-clock ms of ``PredictSession.predict`` per request of
    ``reqs`` (rows -> raw rows), after one warm call each: host binning,
    the copies, one forest launch per dispatch and the transform."""
    import statistics
    from lightgbm_tpu_torch.serve import PredictSession

    sess = PredictSession(bst)
    log("serve latency: %d threads alive (%s)"
        % (threading.active_count(),
           ", ".join(sorted(t.name for t in threading.enumerate()))))
    out = {}
    for n, X in sorted(reqs.items()):
        sess.predict(X)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            sess.predict(X)
            times.append((time.perf_counter() - t0) * 1e3)
        out[n] = statistics.median(times)
        log("serve latency %d rows: median %.3f ms of %d (%s)"
            % (n, out[n], reps, ", ".join("%.3f" % t for t in times)))
    return out


def split_case(name, rng, n=9000, F=8, nb=32):
    """numpy inputs of one split-scan case on seeded rows: ``(bins (n, F)
    u8, ghc (n, 3) f32 on a 1/64 grid, meta dict of (F,) arrays, hp dict,
    fmask (F,) bool, (lows2, ups2, outs2), depth, nan_at)``: the children's
    (2,) bounds and parent outputs, their node depth. ``nan_at`` is the
    (feature, bin) whose parent g is set to NaN (the larger child's gains
    there go NaN and must never win)."""
    import numpy as np
    bins = rng.randint(0, nb, (n, F))
    num_bins = np.full(F, nb, np.int32)
    g = rng.randn(n) * 0.25 + 0.4 * (bins[:, 1] < nb // 2) \
        - 0.3 * (bins[:, 3] > nb // 3)
    h = np.abs(rng.randn(n)) * 0.25 + 0.1
    meta = dict(num_bins=num_bins, movable_missing=np.zeros(F, bool),
                missing_bin=np.zeros(F, np.int32),
                is_categorical=np.zeros(F, bool),
                monotone=np.zeros(F, np.int8),
                penalty=np.ones(F, np.float32),
                cegb_coupled=np.zeros(F, np.float32))
    hp = {"min_data_in_leaf": 20.0}
    fmask = np.ones(F, bool)
    lows2 = np.full(2, -np.inf, np.float32)
    ups2 = np.full(2, np.inf, np.float32)
    outs2 = np.zeros(2, np.float32)
    depth, nan_at = 1, None
    if name in ("nan_left", "nan_right"):
        # the missing bin's rows look like the low bins (default left) or
        # the high ones (default right)
        meta["movable_missing"][0] = True
        meta["missing_bin"][0] = nb - 1
        side = np.where(bins[:, 0] < nb // 2, 1.0, -1.0)
        side[bins[:, 0] == nb - 1] = 1.0 if name == "nan_left" else -1.0
        g = g + 1.5 * side
    elif name == "categorical_onehot":
        bins[:, 2] = rng.randint(0, 5, n)
        num_bins[2] = 5
        meta["is_categorical"][2] = True
        g = g + 1.5 * (bins[:, 2] == 3)
        hp.update(has_categorical=True, max_cat_to_onehot=4)
    elif name in ("categorical_mvm", "categorical_mvm_asc"):
        # categories 1, 4 and 7 pull g up (the descending order wins) or
        # down (the ascending one)
        bins[:, 2] = rng.randint(0, 12, n)
        num_bins[2] = 12
        meta["is_categorical"][2] = True
        sign = 1.5 if name == "categorical_mvm" else -1.5
        g = g + sign * np.isin(bins[:, 2], (1, 4, 7))
        hp.update(has_categorical=True, max_cat_to_onehot=4,
                  min_data_per_group=10.0)
    elif name in ("monotone_penalty", "monotone_shallow"):
        meta["monotone"][1] = -1
        meta["monotone"][3] = 1
        # penalty 1.5 at depth 1: 1 - 2^(p-1-d); 0.5 at depth 3: 1 - p/2^d
        deep = name == "monotone_penalty"
        hp.update(has_monotone=True, monotone_penalty=1.5 if deep else 0.5)
        depth = 1 if deep else 3
        lows2[0], ups2[0] = -2.0, 0.5
    elif name == "masked_fmask":
        fmask[[1, 3]] = False
    elif name == "no_split":
        hp["min_data_in_leaf"] = 1e9
    elif name == "nan_gains":
        nan_at = (1, 5)     # the winning feature of the numerical case
    elif name == "ties":
        # numerical features 4 and 5 and one-vs-rest feature 2 hold the
        # same 3-bin column: equal gains; the flat first maximum is kind
        # 0 (numerical) before kind 1, then the smaller feature
        col = rng.randint(0, 3, n)
        bins[:, 2] = bins[:, 4] = bins[:, 5] = col
        num_bins[[2, 4, 5]] = 3
        meta["is_categorical"][2] = True
        g = g + 1.5 * (col == 0)
        hp.update(has_categorical=True, max_cat_to_onehot=4, cat_l2=0.0)
    elif name == "l1_clip":
        # L1 thresholding moves every gain and zeroes small bins' sums;
        # max_delta_step clips the children's outputs (|G / H| ~ 1)
        hp.update(lambda_l1=5.0, lambda_l2=1.0, max_delta_step=0.05)
    elif name == "path_smooth":
        # outputs pulled toward nonzero parent outputs
        hp.update(path_smooth=50.0)
        outs2[:] = (0.3, -0.2)
    g = np.round(g * 64) / 64
    h = np.round(h * 64) / 64
    ghc = np.stack([g, h, np.ones(n)], axis=1).astype(np.float32)
    return (bins.astype(np.uint8), ghc, meta, hp, fmask,
            (lows2, ups2, outs2), depth, nan_at)


def split_inputs(dev, case, guard=128):
    """One case on ``dev`` as the learner would call the one-kernel split:
    plane 0 packs the rows, the parent is all of them, routed by the last
    feature (noise in every case, so both children keep the case's
    structure) at its middle bin. Returns (work, seg list, table, the
    keyword arguments of ops.partition.one_kernel_split_planes but
    cnt_bound)."""
    import torch
    from lightgbm_tpu_torch.ops.partition import pack_planes, planes_npad
    from lightgbm_tpu_torch.ops.split import FeatureMeta, SplitHyper

    bins, ghc, meta, hp, fmask, (lows2, ups2, outs2), depth, nan_at = case
    n, F = bins.shape
    B = int(meta["num_bins"].max())
    work = torch.zeros((2, F + 12, planes_npad(n, guard)), dtype=torch.uint8,
                       device=dev)
    work[0, :, guard:guard + n] = pack_planes(torch.as_tensor(bins),
                                              torch.as_tensor(ghc)).to(dev)
    seg = [0, guard, n, F - 1]
    table = torch.arange(B, device=dev) <= int(meta["num_bins"][F - 1]) // 2
    kw = dict(depth=depth, hp=SplitHyper(**hp), num_bins=B, num_feat=F,
              meta=FeatureMeta(**{k: torch.as_tensor(v).to(dev)
                                  for k, v in meta.items()}),
              fmask=torch.as_tensor(fmask).to(dev),
              lows2=torch.as_tensor(lows2).to(dev),
              ups2=torch.as_tensor(ups2).to(dev))
    kw = dict(segment_split(work, seg, table, kw),
              outs2=torch.as_tensor(outs2).to(dev))
    if nan_at is not None:
        kw["parent_hist"][nan_at[0], nan_at[1], 0] = float("nan")
    return work, seg, table, kw


def scan_reference(hist_left, hist_right, kw):
    """find_best_split (torch) on the two children's histograms as the
    one-kernel split scans them: (SplitInfo, (2, 4, F, B) candidates)."""
    import torch
    from lightgbm_tpu_torch.ops.split import find_best_split

    args = (torch.stack([hist_left, hist_right]), kw["sums2"], kw["meta"],
            kw["fmask"], kw["hp"])
    opts = dict(parent_output=kw["outs2"], leaf_lower=kw["lows2"],
                leaf_upper=kw["ups2"], node_depth=kw["depth"])
    return (find_best_split(*args, **opts),
            find_best_split(*args, want_candidates=True, **opts))


def compare_split_info(name, got, ref, cand, strict=False, hists=None):
    """The kernel's SplitInfo against the torch scan's on the same
    histograms. Integer fields equal unless the torch winner's margin over
    its runner-up is within the gain tolerance (then the torch scan's gain
    at the kernel's choice must be within it of the best); gains, sums and
    outputs within SPLIT_ATOL + SPLIT_RTOL * |x|. With ``hists`` (the two
    children's (F, B, 3) histograms, which both scans read), the left and
    right sums may also differ by the f32 summation bound over the
    winner's bins: each side sums up to B + 1 of them in its own order
    (the kernel in bin order, torch in its reduction's), so the two differ
    by at most 2 * gamma(B + 1) * (sum of the bins' |x| + |x|). That is
    the bound where the sums cancel (LambdaRank's gradients sum to about 0
    a query), and a bound relative to the result is none. Returns max
    |diff|."""
    import math
    import torch

    worst = 0.0
    for c in (0, 1):
        mine = (int(got.kind[c]), int(got.feature[c]), int(got.bin[c]))
        theirs = (int(ref.kind[c]), int(ref.feature[c]), int(ref.bin[c]))
        top = torch.topk(cand[c].reshape(-1).double(), 2).values.tolist()
        tol = SPLIT_ATOL + SPLIT_RTOL * abs(top[0]) \
            if math.isfinite(top[0]) else 0.0
        decided = strict or not math.isfinite(top[0]) \
            or top[0] - top[1] > tol
        if mine != theirs:
            alt = float(cand[c][mine])
            msg = "%s child %d: winner (kind, feature, bin) %s, torch's " \
                "%s (gains %r vs %r, runner-up %r)" \
                % (name, c, mine, theirs, alt, top[0], top[1])
            if decided or not abs(alt - top[0]) <= tol:
                raise AssertionError(msg)
            log("near tie, accepted: " + msg)
            continue          # the other fields belong to other candidates
        if bool(got.default_left[c]) != bool(ref.default_left[c]) \
                or not torch.equal(got.go_left[c], ref.go_left[c]):
            raise AssertionError("%s child %d: routing table or default "
                                 "direction differs" % (name, c))
        for fld in ("gain", "left_sum", "right_sum", "left_output",
                    "right_output"):
            x = getattr(got, fld)[c].double().reshape(-1)
            y = getattr(ref, fld)[c].double().reshape(-1)
            d = torch.where(x == y, torch.zeros_like(x), (x - y).abs())
            tol = SPLIT_ATOL + SPLIT_RTOL * y.abs()
            if hists is not None and fld in ("left_sum", "right_sum"):
                bins = hists[c, int(got.feature[c])].double().abs().sum(0)
                nu = 2.0 ** -24 * (hists.shape[2] + 1)
                tol = tol + 2 * nu / (1 - nu) * (bins + y.abs())
            if not bool((d <= tol).all()):
                raise AssertionError("%s child %d: %s %s vs torch %s"
                                     % (name, c, fld, x.tolist(),
                                        y.tolist()))
            worst = max(worst, float(d.max()))
    return worst


def check_one_kernel(name, work, seg, table, kw, strict=False,
                     cancelling=False):
    """The one-kernel split (kernel on a CUDA tensor) against its plain
    twin and against the three-launch chain K3 + K4 + parent - child on
    the same input: routed bytes and lt equal to both; hist_left and
    hist_right bit-equal to the chain's, counts equal to the twin's and
    g/h within the f32 summation bound of its float64 sums; the SplitInfo
    against the torch scan on the same histograms (compare_split_info).
    Returns max |diff|."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.ops import partition as P

    dev = work.device
    sg = torch.tensor(seg, dtype=torch.int32, device=dev)
    bound = max(seg[2], 1)
    a, b, c = work.clone(), work.clone(), work.clone()
    lt_a, hl_a, hr_a, got = P.one_kernel_split_planes(a, sg, table,
                                                      cnt_bound=bound, **kw)
    lt_b, hl_b, hr_b, _ = P.one_kernel_split_planes_plain(b, sg, table, **kw)
    lt_c = P.partition_segment(c, sg, table, bound)
    src, start, cnt = seg[:3]
    n_left = int(lt_c)
    ls = kw["left_smaller"]
    hseg = [1 - src, start, n_left] if ls \
        else [1 - src, start + n_left, cnt - n_left]
    hkw = dict(num_bins=kw["num_bins"], num_feat=kw["num_feat"])
    small = H.segment_histogram(c, torch.tensor(hseg, dtype=torch.int32,
                                                device=dev),
                                cnt_bound=bound, **hkw)
    large = kw["parent_hist"] - small
    hl_c, hr_c = (small, large) if ls else (large, small)
    sync(dev)
    if not int(lt_a) == int(lt_b) == n_left:
        raise AssertionError("%s: lt %d, twin %d, K3 %d"
                             % (name, int(lt_a), int(lt_b), n_left))
    if not (torch.equal(a, b) and torch.equal(a, c)):
        raise AssertionError("%s: routed bytes differ (%d from the twin, %d "
                             "from K3)" % (name,
                                           int(torch.count_nonzero(a != b)),
                                           int(torch.count_nonzero(a != c))))
    for x, y in ((hl_a, hl_c), (hr_a, hr_c)):
        if not torch.equal(x.view(torch.int32), y.view(torch.int32)):
            raise AssertionError("%s: child histograms not bit-equal to "
                                 "K3 + K4" % name)
    absum = H.segment_histogram_plain(
        abs_work(c, kw["num_feat"]), torch.tensor(hseg, dtype=torch.int32),
        **hkw).to(dev)
    rel = H.sum_error_bound(bound) + H.sum_error_bound(hseg[2])
    for x, y in ((hl_a, hl_b), (hr_a, hr_b)):
        if not torch.equal(x[..., 2], y[..., 2]):
            raise AssertionError("%s: count channel differs from the twin"
                                 % name)
        diff = (x - y).abs()
        if bool((diff > rel * absum).any()):
            raise AssertionError("%s: g/h off the twin, max |diff| %.3g"
                                 % (name, float(diff.max())))
    ref, cand = scan_reference(hl_c, hr_c, kw)
    return compare_split_info(name, got, ref, cand, strict,
                              hists=torch.stack([hl_c, hr_c])
                              if cancelling else None)


def segment_split(work, seg, table, kw):
    """``kw`` (split_inputs') re-based on the segment ``seg`` routed by
    ``table``: its own parent histogram, the children's sums and which is
    smaller (by the count channel, as the learner decides it), as the
    learner would have them."""
    import torch
    from lightgbm_tpu_torch.ops.histogram import (segment_histogram,
                                                  segment_histogram_plain)
    from lightgbm_tpu_torch.ops.partition import partition_segment_plain

    dev = work.device
    src, start, cnt, _ = seg
    hkw = dict(num_bins=kw["num_bins"], num_feat=kw["num_feat"])
    parent = segment_histogram(work, torch.tensor(seg[:3], dtype=torch.int32,
                                                  device=dev),
                               cnt_bound=max(cnt, 1), **hkw)
    w = work.clone()
    n_left = int(partition_segment_plain(
        w, torch.tensor(seg, dtype=torch.int32, device=dev), table))
    left = segment_histogram_plain(
        w, torch.tensor([1 - src, start, n_left], dtype=torch.int32), **hkw)
    ls = left[0].sum(dim=0)
    total = parent[0].sum(dim=0)
    return dict(kw, parent_hist=parent, left_smaller=bool(ls[2] <= total[2]
                                                          - ls[2]),
                sums2=torch.stack([ls, total - ls]),
                outs2=torch.zeros(2, device=dev))


def phase_one_kernel(dev, rng):
    """The one-kernel split against its twin and K3 + K4, seeded: segment
    shapes (unaligned start, empty left or right side, a one-row child on
    either side, a segment under one tile, the whole buffer) on the
    numerical case, two bagged segments whose smaller child by the count
    channel holds ~3/4 of the rows (bagged_work), then every split-scan
    case of SPLIT_CASES at the root."""
    import torch
    errs = {}
    work, seg, table, kw = split_inputs(dev, split_case("numerical", rng))
    n, col, nb = seg[2], seg[3], kw["num_bins"]
    none = torch.zeros(nb, dtype=torch.bool, device=dev)
    # one row of the segment goes left (bin 1 at its middle row, 0 else)
    one = [0, 128 + 300, 2001, col]
    w_one = work.clone()
    w_one[0, col, one[1]:one[1] + one[2]] = 0
    w_one[0, col, one[1] + one[2] // 2] = 1
    t_one = torch.arange(nb, device=dev) == 1
    w_bag, t_bag = bagged_work(rng, work, col, nb)
    shapes = (("unaligned", work, [0, 128 + 13, 7001, col], table),
              ("empty_left", work, [0, 128 + 100, 777, col], none),
              ("empty_right", work, [0, 128 + 100, 777, col], ~none),
              ("under_one_tile", work, [0, 128 + 4095, 300, col], table),
              ("whole", work, [0, 128, n, col], table),
              ("one_row_left", w_one, one, t_one),
              ("one_row_right", w_one, one, ~t_one),
              ("bagged_left", w_bag, [0, 128 + 13, n - 13, col], t_bag),
              ("bagged_right", w_bag, [0, 128 + 13, n - 13, col], ~t_bag))
    for name, w, sg, tbl in shapes:
        key = "one_kernel/%s" % name
        skw = segment_split(w, sg, tbl, kw)
        if name.startswith("bagged"):
            check_bagged_shape(key, w, sg, tbl, skw)
        errs[key] = check_one_kernel(key, w, sg, tbl, skw)
    for name in SPLIT_CASES:
        key = "one_kernel/scan/%s" % name
        w, sg, tbl, ckw = split_inputs(dev, split_case(name, rng))
        errs[key] = check_one_kernel(key, w, sg, tbl, ckw,
                                     strict=name in EXACT_TIE_CASES)
    return errs


def bagged_work(rng, work, col, nb):
    """A copy of ``work`` (split_inputs' planes, all rows in buffer 0) whose
    rows routed left by the returned table (bins <= 3 nb / 4 of column
    ``col``: ~3/4 of the rows) are four in five out of bag: g = h = cnt =
    0, as bagging packs them. The left child, more than half of the
    parent's rows, is then the smaller one by the count channel (and the
    right one under ~table)."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.ops.partition import GH_BYTES

    w = work.clone()
    width = w.shape[1]
    table = torch.arange(nb, device=w.device) <= 3 * nb // 4
    go = table[w[0, col].long()]
    out = go & torch.as_tensor(rng.rand(w.shape[2]) < 0.8).to(w.device)
    w[0, width - GH_BYTES:, out] = 0
    return w, table


def check_bagged_shape(name, work, seg, table, kw):
    """The case must be one where the smaller child by the count channel
    holds more than half of the parent's physical rows."""
    import torch
    from lightgbm_tpu_torch.ops.partition import partition_segment_plain
    n_left = int(partition_segment_plain(
        work.clone().cpu(), torch.tensor(seg, dtype=torch.int32),
        table.cpu()))
    small = n_left if kw["left_smaller"] else seg[2] - n_left
    if not 2 * small > seg[2]:
        raise AssertionError("%s: the smaller child by count has %d of %d "
                             "rows" % (name, small, seg[2]))


def header_split(op, seg, table, kw):
    """``op`` (a OneKernelSplit) as the learner calls it: its device
    header, pair block and output buffers built once, so that a timed call
    is the launch alone. Returns ``call(stamps=None) -> SplitOut``."""
    import torch
    from lightgbm_tpu_torch.ops import partition as P

    sg = torch.as_tensor(seg, dtype=torch.int32).to(op.work.device)
    hdr = P.split_header(sg, kw["left_smaller"], kw["depth"])
    pair = P.split_pair(kw["sums2"], kw["outs2"], kw["lows2"], kw["ups2"])
    out = P.split_out(op.num_feat, op.num_bins, op.work.device)
    parent = kw["parent_hist"][None]

    def call(stamps=None):
        op.split(hdr, table, parent, pair, out, stamps=stamps)
        return out

    return call


def split_kernel_on_vs_off(dev, data, rows, leaves, iters=3):
    """The same small training with the one-kernel split on and off on the
    card: train logloss within LOGLOSS_TOL (the kernel's scan sums in
    another order than torch's, so near-tie splits may flip), the split
    agreement printed. On the card the on run asks for ``auto``, which
    must resolve to on. Launch counts are zeroed before the on run and
    read after it."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import kernels
    X, y = data[0][:rows], data[1][:rows]
    out = {}
    for sk, knob in (("off", "off"),
                     ("on", "auto" if dev.type == "cuda" else "on")):
        params = dict(train_params(dev, leaves, {"tpu_split_kernel": knob}),
                      metric=["binary_logloss"])
        ds = lgt.Dataset(X, label=y, params=params)
        ds.construct()
        sync(dev)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        bst = lgt.train(params, ds, iters)
        sync(dev)
        if bst.inner.learner._kw["split_kernel"] != sk:
            raise AssertionError("tpu_split_kernel=%s resolved to %s, not %s"
                                 % (knob, bst.inner.learner._kw[
                                     "split_kernel"], sk))
        out[sk] = (bst, time.perf_counter() - t0, bst.eval_train()[0][2],
                   kernels.launch_counts())
    (off, t_off, l_off, _), (on, t_on, l_on, counts) = out["off"], out["on"]
    agree, total, first = split_agreement(on, off)
    log("one-kernel on vs off: %d rows x %d iterations; %d of %d splits "
        "agree (first tree %d of %d); train logloss on %.7f off %.7f; on "
        "%.2f s, off %.2f s; on launches %s"
        % (rows, iters, agree, total, first[0], first[1], l_on, l_off, t_on,
           t_off, counts))
    if abs(l_on - l_off) > LOGLOSS_TOL:
        raise AssertionError("train logloss one-kernel %.6f vs three-launch "
                             "%.6f" % (l_on, l_off))
    if dev.type == "cuda" and counts.get("one_kernel_split", 0) <= 0:
        raise AssertionError("the on run never launched one_kernel_split")
    return dict(splits_agree=agree, splits=total, first_tree=first,
                logloss_on=l_on, logloss_off=l_off)


def full_width_one_kernel(bst, dev, errs, timed=True, cancelling=False):
    """The one-kernel split against its twin and K3 + K4 at the training
    shapes: the root segment of all rows packed from the trained model's
    gradients, routed by the split find_best_split takes on its histogram.
    Then, when ``timed`` (on the card), the kernel's ms, the twin's, the
    three-launch path's (K3, K4 on the smaller child, the subtraction and
    the torch scan, as the learner runs them) and the bound."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.ops import partition as P
    from lightgbm_tpu_torch.ops.split import find_best_split

    g = bst.inner
    lrn = g.learner
    bins = lrn.bins
    n, F = bins.shape
    B = lrn.num_bin_hist
    grad, hess = g.objective.get_gradients(g.train_score.score)
    ghc = torch.stack([grad, hess, torch.ones_like(grad)], dim=1)
    guard, width = P.work_spec(F)
    work = torch.zeros((2, width, P.planes_npad(n, guard)),
                       dtype=torch.uint8, device=dev)
    parent = P.pack_planes_fold_root(work, bins, ghc, guard, num_bins=B,
                                     exact=True)
    fmask = torch.ones(F, dtype=torch.bool, device=dev)
    info = find_best_split(parent, torch.sum(ghc, dim=0), lrn.meta, fmask,
                           lrn.hp)
    seg = [0, guard, n, int(info.feature)]
    table = info.go_left
    kw = dict(left_smaller=bool(info.left_sum[2] <= info.right_sum[2]),
              depth=1, parent_hist=parent, meta=lrn.meta, fmask=fmask,
              sums2=torch.stack([info.left_sum, info.right_sum]),
              outs2=torch.stack([info.left_output, info.right_output]),
              lows2=torch.full((2,), float("-inf"), device=dev),
              ups2=torch.full((2,), float("inf"), device=dev), hp=lrn.hp,
              num_bins=B, num_feat=F)
    errs["one_kernel/full_width"] = check_one_kernel(
        "one_kernel/full_width", work, seg, table, kw,
        cancelling=cancelling)
    if not timed:
        return {}
    sg = torch.tensor(seg, dtype=torch.int32, device=dev)
    # the kernel as the learner calls it: one OneKernelSplit per tree
    op = P.OneKernelSplit(work, kw["meta"], kw["fmask"], kw["hp"],
                          num_bins=B, num_feat=F, cnt_max=n)
    call = header_split(op, seg, table, kw)
    k_ms = cuda_ms(call)
    k_dev = device_ms(call)
    p_ms = cuda_ms(lambda: P.one_kernel_split_planes_plain(work, sg, table,
                                                           **kw),
                   iters=3, warmup=1)
    ls = kw["left_smaller"]

    def three_launch():
        lt = P.partition_segment(work, sg, table, n)
        hseg = torch.empty(3, dtype=torch.int32, device=dev)
        hseg[0] = 1
        if ls:
            hseg[1] = guard
            hseg[2:3] = lt
        else:
            hseg[1:2] = lt + guard
            hseg[2:3] = n - lt
        small = H.segment_histogram(work, hseg, num_bins=B, num_feat=F,
                                    cnt_bound=n)
        large = parent - small
        hl, hr = (small, large) if ls else (large, small)
        return find_best_split(torch.stack([hl, hr]), kw["sums2"],
                               kw["meta"], kw["fmask"], kw["hp"],
                               parent_output=kw["outs2"],
                               leaf_lower=kw["lows2"], leaf_upper=kw["ups2"],
                               node_depth=kw["depth"])

    t_ms = cuda_ms(three_launch)
    n_left = int(P.partition_segment(work.clone(), sg, table, n))
    n_small = n_left if ls else n - n_left
    # the function must read and write each parent row once and read the
    # histograms; the rows of the smaller child can be summed while they
    # are scattered. The design reads them again in phase B: its own floor
    # counts width * n_small bytes more.
    f_bytes = 2 * width * n + 3 * F * B * 12
    log("full width one-kernel split: %.4f ms (device %s, twin %.2f, "
        "three-launch K3 + K4 + torch scan %.4f) at the %d-row root, %d "
        "rows in the smaller child; byte floor of the function %.5f ms, of "
        "the three-phase design %.5f ms"
        % (k_ms, k_dev, p_ms, t_ms, n, n_small,
           f_bytes / PEAK_BYTES_PER_S * 1e3,
           (f_bytes + width * n_small) / PEAK_BYTES_PER_S * 1e3))
    return {"one_kernel_split": dict(
        route="cuda", source="lightgbm_tpu_torch/csrc/one_kernel_split.cu",
        replaces="lightgbm_tpu/ops/partition.py:1465",
        max_abs_err=max(v for k, v in errs.items()
                        if k.startswith("one_kernel/")),
        ms=k_ms, device_ms=k_dev, plain_ms=p_ms, library_ms=None,
        three_launch_ms=t_ms, bytes=f_bytes, ops=n + n_small * F * 5)}


def phase_one_kernel_train(dev, data, trees, leaves, planes, host_rows):
    """The slice-4 path at full width: ``lightgbm_tpu_torch.train`` with
    ``tpu_split_kernel=on`` (one launch per split) on phase 3's data, its
    launch counts (one_kernel_split = splits, no K3, K4 = the roots), the
    per-tree checks, byte-equal determinism, its profiled busy share, on
    vs off and card vs host on ``host_rows`` rows, and valid AUC within
    ONE_KERNEL_AUC_TOL of phase 3's ``planes`` summary."""
    ds = build_datasets(dev, data, leaves, ONE_KERNEL_PARAMS)
    bst, counts, summary = phase_train(dev, ds, trees, leaves,
                                       ONE_KERNEL_PARAMS)
    want = {"one_kernel_split": summary["splits"], "partition_segment": 0,
            "segment_histogram": trees}
    if dev.type == "cuda" and any(counts.get(k, 0) != v
                                  for k, v in want.items()):
        raise AssertionError("one-kernel training launches %s, want %s"
                             % (counts, want))
    check_determinism(dev, ds[0], leaves, extra=ONE_KERNEL_PARAMS)
    if dev.type == "cuda":
        summary["profile"] = profile_iteration(dev, ds[0], leaves,
                                               ONE_KERNEL_PARAMS)
    summary["on_vs_off"] = split_kernel_on_vs_off(dev, data, host_rows,
                                                  leaves)
    summary["card_vs_host"] = card_vs_host(dev, data, host_rows, leaves,
                                           extra=ONE_KERNEL_PARAMS)
    gap = abs(summary["valid_auc"] - planes["valid_auc"])
    log("valid auc after %d trees: three-launch %.5f, one-kernel %.5f "
        "(|diff| %.5f, limit %.3f); ms per tree %.1f vs %.1f (the device's "
        "busy shares on the profile lines)"
        % (trees, planes["valid_auc"], summary["valid_auc"], gap,
           ONE_KERNEL_AUC_TOL, planes["wall_per_tree_ms"],
           summary["wall_per_tree_ms"]))
    if gap > ONE_KERNEL_AUC_TOL:
        raise AssertionError("one-kernel valid auc %.5f vs three-launch %.5f"
                             % (summary["valid_auc"], planes["valid_auc"]))
    return bst, counts, summary


# ------------------------------------------------------------ resident layout

def resident_pair(dev, bins_all, res, rows, ghc, rng=None, guard=128):
    """One segment on both layouts: rows ``rows`` (ascending indices into
    the (N, F) u8 ``bins_all``, whose resident planes are ``res``) with
    ``ghc`` (their (m, 3) f32 channels), in order at lanes ``guard ..`` of
    buffer 0. Returns (the slim pair, the planes pair). With ``rng`` every
    other lane and buffer 1 hold junk: stale bytes the kernels must never
    follow."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.ops.partition import (RST_WIDTH, pack_planes,
                                                  pack_resident, planes_npad)

    m, F = rows.shape[0], bins_all.shape[1]
    npad = planes_npad(m, guard)

    def buf(width):
        if rng is None:
            return torch.zeros((2, width, npad), dtype=torch.uint8,
                               device=dev)
        return torch.as_tensor(rng.randint(0, 256, (2, width, npad))
                               .astype(np.uint8)).to(dev)

    slim, planes = buf(RST_WIDTH), buf(F + 12)
    slim[0, :, guard:guard + m] = pack_resident(rows, ghc)
    planes[0, :, guard:guard + m] = pack_planes(bins_all[rows], ghc)
    return slim, planes


def seeded_resident(rng, bins, dev, spread=3):
    """The rows of ``bins`` (n, F) u8 as a sparse ascending subset of a
    ``spread * n``-row matrix (the other rows random bins), as the rows of
    a deep leaf sit in the resident planes. Returns (all bins, the (F,
    Npad) resident planes, the rows' indices)."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.learner import route_layout

    n, F = bins.shape
    nb = max(int(bins.max()) + 1, 2)
    bins_all = torch.as_tensor(rng.randint(0, nb, (spread * n, F))
                               .astype(np.uint8))
    rows = torch.as_tensor(np.sort(rng.choice(spread * n, n,
                                              replace=False)))
    bins_all[rows] = torch.as_tensor(bins)
    bins_all = bins_all.to(dev)
    return bins_all, route_layout(bins_all).reshape(F, -1), rows.to(dev)


def check_route(name, slim, res, planes, seg):
    """Route gather kernel vs twin: the whole slim pair equal; the route
    bytes equal to the planes layout's split column on the same rows."""
    import torch
    from lightgbm_tpu_torch.ops import partition as P

    a, b = slim.clone(), slim.clone()
    sg = torch.tensor(seg, dtype=torch.int32, device=slim.device)
    P.write_route_plane(a, res, sg, max(seg[2], 1))
    P.write_route_plane_plain(b, res, sg)
    sync(slim.device)
    src, start, cnt, col = seg
    if not torch.equal(a, b):
        raise AssertionError("%s: %d bytes differ from the twin" % (
            name, int(torch.count_nonzero(a != b))))
    if not torch.equal(a[src, 0, start:start + cnt],
                       planes[src, col, start:start + cnt]):
        raise AssertionError("%s: route bytes differ from the planes "
                             "column" % name)
    return 0.0


def check_histogram_resident(name, slim, res, planes, seg, num_bins,
                             num_feat, exact):
    """Resident histogram kernel vs twin (counts equal, g/h within the
    f32 summation bound of the twin's float64 sum), bit-equal run to run
    and to the planes kernel on the same rows. Returns max |diff|."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as H

    sg = torch.tensor(seg, dtype=torch.int32, device=slim.device)
    kw = dict(num_bins=num_bins, num_feat=num_feat, exact=exact)
    bound = max(seg[2], 1)
    got = H.segment_histogram_resident(slim, res, sg, cnt_bound=bound, **kw)
    want = H.segment_histogram_resident_plain(slim, res, sg, **kw)
    other = H.segment_histogram(planes, sg, cnt_bound=bound, **kw)
    check_bound_invariant(name, lambda b: H.segment_histogram_resident(
        slim, res, sg, cnt_bound=b, **kw), got, seg[2])
    absum = H.segment_histogram_plain(abs_work(planes, num_feat), sg, **kw)
    sync(slim.device)
    if not torch.equal(got[..., 2], want[..., 2]):
        raise AssertionError("%s: count channel differs" % name)
    diff = (got - want).abs()
    if not torch.isfinite(got).all() \
            or (diff > H.sum_error_bound(seg[2]) * absum).any():
        raise AssertionError("%s: g/h off, max |diff| %.3g"
                             % (name, float(diff.max())))
    if not torch.equal(got.view(torch.int32), other.view(torch.int32)):
        raise AssertionError("%s: not bit-equal to the planes kernel" % name)
    return float(diff.max())


def check_one_kernel_resident(name, slim, res, planes, seg, table, kw):
    """The one-kernel split's resident mode against its twin, against the
    resident three-launch chain (route gather, K3 on the route plane, the
    resident histogram of the smaller child, parent minus child) and
    against its planes mode on the same rows: lt equal to all three; the
    routed slim bytes equal to the twin's and the chain's; the child
    histograms bit-equal to the chain's and to the planes mode's, counts
    equal to the twin's and g/h within the f32 summation bound of its
    float64 sums; every SplitInfo field bit-equal to the planes mode's.
    Returns max |diff| against the twin's histograms."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.ops import partition as P

    dev = slim.device
    sg = torch.tensor(seg, dtype=torch.int32, device=dev)
    bound = max(seg[2], 1)
    a, b, c, p = slim.clone(), slim.clone(), slim.clone(), planes.clone()
    lt_a, hl_a, hr_a, got = P.one_kernel_split_planes(
        a, sg, table, cnt_bound=bound, resident=res, **kw)
    lt_b, hl_b, hr_b, _ = P.one_kernel_split_planes_plain(
        b, sg, table, resident=res, **kw)
    P.write_route_plane(c, res, sg, bound)
    lt_c = P.partition_segment(c, P.on_route_plane(sg), table, bound)
    lt_p, hl_p, hr_p, want = P.one_kernel_split_planes(
        p, sg, table, cnt_bound=bound, **kw)
    src, start, cnt = seg[:3]
    n_left = int(lt_c)
    ls = kw["left_smaller"]
    hseg = torch.tensor([1 - src, start, n_left] if ls
                        else [1 - src, start + n_left, cnt - n_left],
                        dtype=torch.int32, device=dev)
    hkw = dict(num_bins=kw["num_bins"], num_feat=kw["num_feat"])
    small = H.segment_histogram_resident(c, res, hseg, cnt_bound=bound,
                                         **hkw)
    large = kw["parent_hist"] - small
    hl_c, hr_c = (small, large) if ls else (large, small)
    absum = H.segment_histogram_plain(abs_work(p, kw["num_feat"]), hseg,
                                      **hkw)
    sync(dev)
    if not int(lt_a) == int(lt_b) == n_left == int(lt_p):
        raise AssertionError("%s: lt %d, twin %d, chain %d, planes %d"
                             % (name, int(lt_a), int(lt_b), n_left,
                                int(lt_p)))
    if not (torch.equal(a, b) and torch.equal(a, c)):
        raise AssertionError("%s: routed bytes differ (%d from the twin, %d "
                             "from the chain)" % (
                                 name, int(torch.count_nonzero(a != b)),
                                 int(torch.count_nonzero(a != c))))

    def bits(x):
        return x.contiguous().view(torch.uint8)

    for x, y, z in ((hl_a, hl_c, hl_p), (hr_a, hr_c, hr_p)):
        if not (torch.equal(bits(x), bits(y)) and torch.equal(bits(x),
                                                              bits(z))):
            raise AssertionError("%s: child histograms not bit-equal to the "
                                 "chain's and the planes mode's" % name)
    rel = H.sum_error_bound(bound) + H.sum_error_bound(int(hseg[2]))
    worst = 0.0
    for x, y in ((hl_a, hl_b), (hr_a, hr_b)):
        if not torch.equal(x[..., 2], y[..., 2]):
            raise AssertionError("%s: count channel differs from the twin"
                                 % name)
        diff = (x - y).abs()
        if bool((diff > rel * absum).any()):
            raise AssertionError("%s: g/h off the twin, max |diff| %.3g"
                                 % (name, float(diff.max())))
        worst = max(worst, float(diff.max()))
    for fld in got._fields:
        if not torch.equal(bits(getattr(got, fld)), bits(getattr(want, fld))):
            raise AssertionError("%s: SplitInfo.%s differs from the planes "
                                 "mode's" % (name, fld))
    return worst


def phase_resident_kernels(dev, rng):
    """The resident layout's kernels against their twins and the planes
    kernels on the same rows, seeded; the segments' rows are a sparse
    ascending third of the resident planes (a deep leaf's gather): the
    route gather on PART_CASES' segments, the resident histogram on
    HIST_CASES' (hi/lo and bf16), and the one-kernel split's resident mode
    on segment shapes of the numerical case, then on every case of
    SPLIT_CASES at the root, and on a bagged segment (bagged_work)."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.ops import partition as P

    n, nb, F = 9000, 64, 10
    bins = rng.randint(0, nb, (n, F)).astype(np.uint8)
    bins_all, res, rows = seeded_resident(rng, bins, dev)
    ghc = torch.as_tensor(np.stack([rng.randn(n) * 2,
                                    np.abs(rng.randn(n)) + 0.01,
                                    np.ones(n)], axis=1)
                          .astype(np.float32)).to(dev)
    slim, planes = resident_pair(dev, bins_all, res, rows, ghc, rng)
    errs = {}
    for name, seg, _ in PART_CASES:
        key = "route/" + name
        errs[key] = check_route(key, slim, res, planes, seg)
    for exact in (True, False):
        for name, seg in HIST_CASES:
            key = "histogram_resident/%s/%s" % ("hilo" if exact else "bf16",
                                                name)
            errs[key] = check_histogram_resident(key, slim, res, planes, seg,
                                                 nb, F, exact)
    for i, name in enumerate(("numerical",) + SPLIT_CASES):
        case = split_case(name, rng)
        work, seg, table, kw = split_inputs(dev, case)
        bins_all, res, rows = seeded_resident(rng, case[0], dev)
        ghc = torch.as_tensor(case[1]).to(dev)
        slim, _ = resident_pair(dev, bins_all, res, rows, ghc, rng)
        if i:
            key = "one_kernel_resident/scan/%s" % name
            errs[key] = check_one_kernel_resident(key, slim, res, work, seg,
                                                  table, kw)
            continue
        col = seg[3]
        shapes = (("unaligned", [0, 128 + 13, 7001, col], table),
                  ("empty_left", [0, 128 + 100, 777, col],
                   torch.zeros_like(table)),
                  ("under_one_tile", [0, 128 + 4095, 300, col], table),
                  ("whole", seg, table))
        for sname, sg, tbl in shapes:
            key = "one_kernel_resident/%s" % sname
            errs[key] = check_one_kernel_resident(
                key, slim, res, work, sg, tbl,
                segment_split(work, sg, tbl, kw))
        # the bagged case: the slim rows carry the planes' zeroed channels
        w_bag, t_bag = bagged_work(rng, work, col, kw["num_bins"])
        s_bag = slim.clone()
        s_bag[0, P.RST_GH_OFF:] = w_bag[0, work.shape[1] - P.GH_BYTES:]
        sg = [0, 128 + 13, seg[2] - 13, col]
        key = "one_kernel_resident/bagged"
        bkw = segment_split(w_bag, sg, t_bag, kw)
        check_bagged_shape(key, w_bag, sg, t_bag, bkw)
        errs[key] = check_one_kernel_resident(key, s_bag, res, w_bag, sg,
                                              t_bag, bkw)
    return errs


def resident_vs_planes(dev, data, rows, leaves, iters=3):
    """Three-launch training on the resident layout against the planes
    layout (``tpu_split_kernel=off`` both): byte-equal model strings.
    Launch counts are zeroed before the resident run and read after it;
    on the card the route gather, K3 and the resident histogram must have
    run."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import kernels
    X, y = data[0][:rows], data[1][:rows]
    ds = lgt.Dataset(X, label=y, params=train_params(dev, leaves))
    planes = lgt.train(train_params(dev, leaves), ds, iters)
    sync(dev)
    kernels.reset_launch_counts()
    res_bst = lgt.train(train_params(dev, leaves,
                                     {"tpu_resident_state": "on"}), ds, iters)
    sync(dev)
    counts = kernels.launch_counts()
    a, b = planes.model_to_string(), res_bst.model_to_string()
    log("resident vs planes, three launches: %d rows x %d iterations, model "
        "strings %s (%d bytes); resident launches %s"
        % (rows, iters, "byte-equal" if a == b else "DIFFER", len(a),
           counts))
    if res_bst.inner.learner._kw["work_layout"] != "resident":
        raise AssertionError("tpu_resident_state=on did not train resident")
    if a != b:
        raise AssertionError("resident and planes layouts grew different "
                             "models")
    if dev.type == "cuda":
        for name in ("write_route_plane", "partition_segment",
                     "segment_histogram_resident"):
            if counts.get(name, 0) <= 0:
                raise AssertionError("the resident run never launched %s"
                                     % name)
    return counts


def phase_resident_train(dev, data, trees, leaves, one_kernel, host_rows):
    """The slice-5 path at full width: ``lightgbm_tpu_torch.train`` with
    RESIDENT_PARAMS on phase 3's data: launches (the resident one-kernel
    split = splits, the resident histogram = the roots, no K3, K4, route
    gather or planes one-kernel split), the per-tree checks, the model
    string byte-equal to phase 3b's (``one_kernel``: its booster and
    summary), served by PredictSession against the plain path, byte-equal
    determinism, its profiled busy share; resident
    against planes three-launch training and card against host on
    ``host_rows`` rows."""
    ok_bst, ok_summary = one_kernel
    ds = build_datasets(dev, data, leaves, RESIDENT_PARAMS)
    bst, counts, summary = phase_train(dev, ds, trees, leaves,
                                       RESIDENT_PARAMS)
    if summary["layout"] != "resident":
        raise AssertionError("resident training ran on the %s layout"
                             % summary["layout"])
    want = {"one_kernel_split_resident": summary["splits"],
            "segment_histogram_resident": trees, "one_kernel_split": 0,
            "partition_segment": 0, "segment_histogram": 0,
            "write_route_plane": 0}
    if dev.type == "cuda" and any(counts.get(k, 0) != v
                                  for k, v in want.items()):
        raise AssertionError("resident training launches %s, want %s"
                             % (counts, want))
    a, b = bst.model_to_string(), ok_bst.model_to_string()
    log("resident vs planes, one kernel per split: %d trees, model strings "
        "%s (%d bytes); ms per tree %.1f vs %.1f"
        % (trees, "byte-equal" if a == b else "DIFFER", len(a),
           summary["wall_per_tree_ms"], ok_summary["wall_per_tree_ms"]))
    if a != b:
        raise AssertionError("resident one-kernel training grew another "
                             "model than planes one-kernel training")
    # the slice-1 path serves it: the forest kernel against the plain twin
    from lightgbm_tpu_torch.serve import PredictSession
    Xq = data[2][:4096]
    summary["serve_err"] = check_scores(
        "serve/resident", PredictSession(bst).predict(Xq),
        TwinPredict(bst).predict(Xq))
    check_determinism(dev, ds[0], leaves, extra=RESIDENT_PARAMS)
    if dev.type == "cuda":
        summary["profile"] = profile_iteration(dev, ds[0], leaves,
                                               RESIDENT_PARAMS)
    summary["three_launch"] = resident_vs_planes(dev, data, host_rows,
                                                 leaves)
    summary["card_vs_host"] = card_vs_host(dev, data, host_rows, leaves,
                                           extra=RESIDENT_PARAMS)
    return bst, counts, summary


def deep_leaf_rows(bst, dev, target=8192):
    """The rows of the first tree's leaf whose size is closest to
    ``target``, ascending (as they sit in that leaf's slim segment), and
    the leaf's depth."""
    import torch
    from lightgbm_tpu_torch.learner import assign_leaves
    from lightgbm_tpu_torch.ops.predict import tree_to_bin_log

    g = bst.inner
    lrn = g.learner
    t0 = g.models[0]
    slot = assign_leaves(lrn.bins, tree_to_bin_log(t0, g.train_set, dev),
                         has_categorical=False, bins_t=lrn.bins_t)
    sizes = torch.bincount(slot.long())
    pick = int(torch.argmin((sizes - target).abs()))
    leaf_of_slot = t0.to_split_arrays()["leaf_of_slot"]
    depth = int(t0.leaf_depths()[leaf_of_slot[pick]])
    return torch.nonzero(slot == pick).reshape(-1), depth


def model_ghc(bst):
    """(N, 3) f32 g, h, cnt of the model's training rows at its scores."""
    import torch
    g = bst.inner
    grad, hess = g.objective.get_gradients(g.train_score.score)
    return torch.stack([grad, hess, torch.ones_like(grad)], dim=1)


def model_segment(bst, dev, idx, depth, start=128):
    """The split of the training rows ``idx`` (ascending) of a trained
    model, as the learner would run it with the model's gradients: the
    rows at lanes ``start`` .. of buffer 0 of a slim pair and a planes pair
    (resident_pair), routed by the split find_best_split takes on their
    histogram, at node depth ``depth``. Returns (slim, planes, seg, table,
    the keyword arguments of ops.partition.one_kernel_split_planes but
    cnt_bound and resident)."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.ops.split import find_best_split

    lrn = bst.inner.learner
    n, F = lrn.bins.shape
    B = lrn.num_bin_hist
    m = int(idx.shape[0])
    gs = model_ghc(bst)[idx]
    slim, planes = resident_pair(dev, lrn.bins, lrn.bins_t.reshape(F, -1),
                                 idx, gs, guard=start)
    seg3 = [0, start, m]
    parent = H.segment_histogram(
        planes, torch.tensor(seg3, dtype=torch.int32, device=dev),
        num_bins=B, num_feat=F, cnt_bound=m)
    fmask = torch.ones(F, dtype=torch.bool, device=dev)
    info = find_best_split(parent, torch.sum(gs, dim=0), lrn.meta, fmask,
                           lrn.hp)
    kw = dict(left_smaller=bool(info.left_sum[2] <= info.right_sum[2]),
              depth=depth, parent_hist=parent, meta=lrn.meta, fmask=fmask,
              sums2=torch.stack([info.left_sum, info.right_sum]),
              outs2=torch.stack([info.left_output, info.right_output]),
              lows2=torch.full((2,), float("-inf"), device=dev),
              ups2=torch.full((2,), float("inf"), device=dev), hp=lrn.hp,
              num_bins=B, num_feat=F)
    return slim, planes, seg3 + [int(info.feature)], info.go_left, kw


def stamp_phases(stamps, phases=None):
    """Per phase of ``phases`` (ONE_KERNEL_PHASES by default), the
    earliest start and the latest end over the blocks (ms from the
    launch's first stamp), and the launch's device ms (its last stamp
    minus its first), from a stamp buffer the kernel filled."""
    from lightgbm_tpu_torch.ops.partition import ONE_KERNEL_PHASES
    st = stamps[stamps[:, 0] != 0].double()
    t0 = float(st[:, 0].min())
    out = {}
    for name, a, b in phases or ONE_KERNEL_PHASES:
        ran = st[st[:, b] != 0]        # the blocks that ran the phase
        if ran.shape[0]:
            out[name] = ((float(ran[:, a].min()) - t0) * 1e-6,
                         (float(ran[:, b].max()) - t0) * 1e-6)
    return out, (float(st.max()) - t0) * 1e-6, int(st.shape[0])


def b7_breakdown(bst, dev, reps=5):
    """B7's per-phase breakdown from the kernel's own %globaltimer stamps,
    planes and resident mode, at three splits of a trained model: the
    2M-row root, a leaf of ~64k rows and the deep leaf of ~8k rows
    (deep_leaf_rows), each split as the learner would take it
    (model_segment). Each mode is launched ``reps`` times after a warm-up;
    the launch with the median device time is printed. Returns {split:
    {mode: (device ms, {phase: (start, end) ms})}}."""
    import torch
    from lightgbm_tpu_torch.ops import partition as P

    lrn = bst.inner.learner
    n, F = lrn.bins.shape
    res = lrn.bins_t.reshape(F, -1)
    out = {}
    for tag, target in (("root", None), ("mid", 65536), ("deep", 8192)):
        if target is None:
            idx, depth = torch.arange(n, device=dev), 1
        else:
            idx, depth = deep_leaf_rows(bst, dev, target)
        slim, planes, seg, table, kw = model_segment(bst, dev, idx, depth)
        m = int(idx.shape[0])
        out[tag] = {}
        for mode, work, extra in (("planes", planes, {}),
                                  ("resident", slim, {"resident": res})):
            op = P.OneKernelSplit(work, kw["meta"], kw["fmask"], kw["hp"],
                                  num_bins=kw["num_bins"], num_feat=F,
                                  cnt_max=m, **extra)
            call = header_split(op, seg, table, kw)
            call()
            runs = []
            for _ in range(reps):
                st = P.stamp_buffer(dev)
                lt = call(stamps=st).lt
                sync(dev)
                runs.append(stamp_phases(st.cpu()))
            phases, ms, blocks = sorted(runs, key=lambda r: r[1])[reps // 2]
            n_left = int(lt)
            small = n_left if kw["left_smaller"] else m - n_left
            # each phase's share of the critical path: from the previous
            # phase's last block to its own last block
            crit, prev = {}, 0.0
            for k, (_, b) in phases.items():
                crit[k], prev = b - prev, b
            log("b7 breakdown %s %s: %d rows (depth %d, %d in the smaller "
                "child), %d blocks, device %.4f ms (median of %d): %s; "
                "critical path %s"
                % (tag, mode, m, depth, small, blocks, ms, reps,
                   "; ".join("%s %.4f-%.4f" % (k, a, b)
                             for k, (a, b) in phases.items()),
                   "; ".join("%s %.4f" % kv for kv in crit.items())))
            out[tag][mode] = (ms, phases)
    return out


def launch_floor_ms(dev):
    """The device ms of a one-element torch kernel (``device_ms`` over 50
    queued launches): the least time a launch takes on this card."""
    import torch
    x = torch.zeros(1, device=dev)
    return device_ms(lambda: x.add_(1.0), iters=50)


def median_stamped(launch, buffer, phases, reps):
    """``launch(stamps)`` ``reps`` times, each into a fresh ``buffer()``;
    the run with the median device time as stamp_phases gives it, and each
    phase's share of the critical path (from the previous phase's last
    stamp to its own)."""
    runs = []
    for _ in range(reps):
        st = buffer()
        launch(st)
        sync(st.device)
        runs.append(stamp_phases(st.cpu(), phases))
    ph, ms, blocks = sorted(runs, key=lambda r: r[1])[reps // 2]
    crit, prev = {}, 0.0
    for k, (_, b) in ph.items():
        crit[k], prev = b - prev, b
    return ph, ms, blocks, crit


def log_scan_stamps(what, call, dev, reps=5):
    """The split scan's stamped phases (median of ``reps`` launches of
    ``call(stamps=...)``) into the log; returns them."""
    from lightgbm_tpu_torch.ops import scan as S

    ph, ms, blocks, crit = median_stamped(
        lambda st: call(stamps=st), lambda: S.scan_stamp_buffer(dev),
        S.SCAN_PHASES, reps)
    log("%s: stamped %.4f ms (median of %d, %d CTAs): %s; critical path %s"
        % (what, ms, reps, blocks,
           "; ".join("%s %.4f-%.4f" % (k, a, b) for k, (a, b) in ph.items()),
           "; ".join("%s %.4f" % kv for kv in crit.items())))
    return dict(stamped_ms=ms, blocks=blocks, phases=ph, critical=crit)


def scan_commit_breakdown(bst, dev, reps=5):
    """The split scan's and the split commit's phases from their own
    %globaltimer stamps on a fused chain model's device tree loop (its
    gradients): the scan at the root split and the tree's last live split
    (ops/scan.SCAN_PHASES), the commit at the middle slot
    (ops/commit.COMMIT_PHASES), each the median of ``reps`` stamped
    launches beside its device_ms, and the launch floor. Returns a
    dict."""
    import torch
    from lightgbm_tpu_torch.ops import commit as C
    from lightgbm_tpu_torch.ops import scan as S

    g = bst.inner
    lrn = g.learner
    grad, hess = g.objective.get_gradients(g.train_score.score)
    ghc = torch.stack([grad, hess, torch.ones_like(grad)], dim=1)
    L = lrn.num_leaves
    loop = loop_state_at(lrn, ghc, L - 1)
    live = loop.state.hdr[:, 6].cpu()
    deep = max(s for s in range(L - 1) if int(live[s]) == 1)
    floor = launch_floor_ms(dev)
    out = {"launch_floor_device_ms": floor, "card": None}
    log("launch floor: a one-element torch kernel %.4f device ms" % floor)
    for where, s in (("root", 0), ("deep", deep)):
        loop, call = scan_call_at(lrn, ghc, s)
        ph, ms, blocks, crit = median_stamped(
            lambda st: call(stamps=st), lambda: S.scan_stamp_buffer(dev),
            S.SCAN_PHASES, reps)
        dms = device_ms(call)
        log("scan breakdown %s (slot %d): device %.4f ms, stamped %.4f ms "
            "(median of %d, %d blocks): %s; critical path %s"
            % (where, s, dms, ms, reps, blocks,
               "; ".join("%s %.4f-%.4f" % (k, a, b)
                         for k, (a, b) in ph.items()),
               "; ".join("%s %.4f" % kv for kv in crit.items())))
        out["scan_" + where] = dict(slot=s, device_ms=dms, stamped_ms=ms,
                                    blocks=blocks, phases=ph, critical=crit)
    s = L // 2
    loop = loop_state_at(lrn, ghc, s)
    st = C.TreeState(*(t.clone() for t in loop.state))
    op = C.SplitCommit(st, loop.out, max_depth=loop.commit.max_depth,
                       monotone=lrn.meta.monotone,
                       has_monotone=lrn.hp.has_monotone,
                       pooled=loop.pooled)
    ph, ms, blocks, crit = median_stamped(
        lambda stp: op(s, stamps=stp),
        lambda: torch.zeros((C.COMMIT_MAX_GRID, C.COMMIT_STAMP_SLOTS),
                            dtype=torch.int64, device=dev),
        C.COMMIT_PHASES, reps)
    dms = device_ms(lambda: op(s))
    log("commit breakdown (slot %d of %d): device %.4f ms, stamped %.4f ms "
        "(median of %d, %d blocks): %s; critical path %s"
        % (s, L, dms, ms, reps, blocks,
           "; ".join("%s %.4f-%.4f" % (k, a, b) for k, (a, b) in ph.items()),
           "; ".join("%s %.4f" % kv for kv in crit.items())))
    out["commit_mid"] = dict(slot=s, device_ms=dms, stamped_ms=ms,
                             blocks=blocks, phases=ph, critical=crit)
    return out


def cluster_probe(dev):
    """Whether the card takes a thread block cluster dimension together
    with the cooperative launch attribute (which one_kernel_split.cu needs
    for its grid barriers): the library's one_kernel_cluster_probe, a
    2-block cooperative launch in clusters of 2. Returns (CUDA status
    code, its name, the cluster size each block saw)."""
    import ctypes
    import torch
    from lightgbm_tpu_torch.ops import partition as P

    P.ONE_KERNEL.load()
    lib = ctypes.CDLL(str(P.ONE_KERNEL.library_path()))
    fn = lib.one_kernel_cluster_probe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib.lgbt_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    out = torch.zeros(2, dtype=torch.int32, device=dev)
    rc = fn(out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    sizes = out.tolist()
    log("cluster dimension with a cooperative launch: %s (status %d, %s); "
        "cluster sizes seen %s" % ("accepted" if rc == 0 else "refused", rc,
                                   err(rc).decode(), sizes))
    return rc, err(rc).decode(), sizes


def full_width_resident(bst, dev, errs, timed=True):
    """The resident kernels at the training shapes of the resident model
    (phase 3c): the 2M-row root (ridx the identity) and a deep leaf's rows
    (deep_leaf_rows: sparse ridx), packed from the model's gradients on
    both layouts, routed by the split find_best_split takes on the
    segment's histogram. Each segment: the route gather, the resident
    histogram and the one-kernel split's resident mode against their twins
    and the planes kernels (check_route, check_histogram_resident,
    check_one_kernel_resident). Then, when ``timed`` (on the card), each
    kernel's ms beside the planes kernel's on the same rows, the twin's,
    the resident three-launch chain's, the library call's and the
    bounds."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.ops import partition as P
    from lightgbm_tpu_torch.ops.split import find_best_split

    g = bst.inner
    lrn = g.learner
    bins = lrn.bins
    n, F = bins.shape
    B = lrn.num_bin_hist
    res = lrn.bins_t.reshape(F, -1)
    deep, depth = deep_leaf_rows(bst, dev)
    rows = {}
    for tag, idx in (("root", torch.arange(n, device=dev)), ("deep", deep)):
        m = int(idx.shape[0])
        slim, planes, seg, table, kw = model_segment(
            bst, dev, idx, depth if tag == "deep" else 1)
        seg3 = seg[:3]
        sg3 = torch.tensor(seg3, dtype=torch.int32, device=dev)
        parent = kw["parent_hist"]
        gs = model_ghc(bst)[idx]
        errs["route/full_width_" + tag] = check_route(
            "route/full_width_" + tag, slim, res, planes, seg)
        errs["histogram_resident/full_width_" + tag] = \
            check_histogram_resident("histogram_resident/full_width_" + tag,
                                     slim, res, planes, seg3, B, F, True)
        errs["one_kernel_resident/full_width_" + tag] = \
            check_one_kernel_resident("one_kernel_resident/full_width_"
                                      + tag, slim, res, planes, seg, table,
                                      kw)
        if not timed:
            continue
        sg = torch.tensor(seg, dtype=torch.int32, device=dev)
        n_left = int(P.partition_segment(planes.clone(), sg, table, m))
        n_small = n_left if kw["left_smaller"] else m - n_left
        ls = kw["left_smaller"]

        def resident_three_launch():
            P.write_route_plane(slim, res, sg, m)
            lt = P.partition_segment(slim, P.on_route_plane(sg), table, m)
            hseg = torch.empty(3, dtype=torch.int32, device=dev)
            hseg[0] = 1
            if ls:
                hseg[1] = 128
                hseg[2:3] = lt
            else:
                hseg[1:2] = lt + 128
                hseg[2:3] = m - lt
            small = H.segment_histogram_resident(slim, res, hseg,
                                                 num_bins=B, num_feat=F,
                                                 cnt_bound=m)
            large = parent - small
            hl, hr = (small, large) if ls else (large, small)
            return find_best_split(torch.stack([hl, hr]), kw["sums2"],
                                   kw["meta"], kw["fmask"], kw["hp"],
                                   parent_output=kw["outs2"],
                                   leaf_lower=kw["lows2"],
                                   leaf_upper=kw["ups2"],
                                   node_depth=kw["depth"])

        slow = dict(iters=3, warmup=1)
        rows_pair = planes.transpose(1, 2).contiguous()   # rows layout
        # the kernel as the learner calls it: one OneKernelSplit per tree
        ops = {mode: P.OneKernelSplit(w, kw["meta"], kw["fmask"], kw["hp"],
                                      num_bins=B, num_feat=F, cnt_max=m,
                                      **extra)
               for mode, w, extra in (("b7", slim, {"resident": res}),
                                      ("b7_planes", planes, {}))}
        calls = {mode: header_split(op, seg, table, kw)
                 for mode, op in ops.items()}

        def b7(mode):
            return calls[mode]

        t = {
            "b7": cuda_ms(b7("b7")),
            "b7_planes": cuda_ms(b7("b7_planes")),
            "b7_plain": cuda_ms(lambda: P.one_kernel_split_planes_plain(
                slim, sg, table, resident=res, **kw), **slow),
            "three_launch": cuda_ms(resident_three_launch),
            "hist": cuda_ms(lambda: H.segment_histogram_resident(
                slim, res, sg3, num_bins=B, num_feat=F, cnt_bound=m)),
            "hist_planes": cuda_ms(lambda: H.segment_histogram(
                planes, sg3, num_bins=B, num_feat=F, cnt_bound=m)),
            "hist_rows": cuda_ms(lambda: H.segment_histogram_rows(
                rows_pair, sg3, num_bins=B, num_feat=F, cnt_bound=m)),
            "hist_plain": cuda_ms(lambda: H.segment_histogram_resident_plain(
                slim, res, sg3, num_bins=B, num_feat=F), **slow),
            "route": cuda_ms(lambda: P.write_route_plane(slim, res, sg, m)),
            "route_plain": cuda_ms(lambda: P.write_route_plane_plain(
                slim, res, sg), **slow)}
        # library yardsticks on precomputed indices: one index_add_ over
        # the gathered bins' flat (f*B + bin) indices with the rows'
        # channels repeated per feature; one index_select of the split
        # column through the rows' indices
        flat = (bins[idx].long() + torch.arange(F, device=dev) * B).t() \
            .reshape(-1)
        vals = gs.repeat(F, 1)
        out = torch.zeros((F * B, 3), device=dev)
        col = res[seg[3]]
        t["hist_library"] = cuda_ms(
            lambda: out.zero_().index_add_(0, flat, vals))
        t["route_library"] = cuda_ms(lambda: col.index_select(0, idx))
        # the same, device time only (launch overhead hidden)
        dev_t = {
            "b7": device_ms(b7("b7")), "b7_planes": device_ms(b7("b7_planes")),
            "hist": device_ms(lambda: H.segment_histogram_resident(
                slim, res, sg3, num_bins=B, num_feat=F, cnt_bound=m)),
            "hist_planes": device_ms(lambda: H.segment_histogram(
                planes, sg3, num_bins=B, num_feat=F, cnt_bound=m)),
            "hist_rows": device_ms(lambda: H.segment_histogram_rows(
                rows_pair, sg3, num_bins=B, num_feat=F, cnt_bound=m)),
            "route": device_ms(lambda: P.write_route_plane(slim, res, sg, m)),
            "route_library": device_ms(lambda: col.index_select(0, idx))}
        hist_bytes = 3 * F * B * 12
        b = {"b7": 2 * P.RST_WIDTH * m + m + F * n_small + hist_bytes,
             "hist": (P.RST_RIDX + P.GH_BYTES + F) * m + F * B * 3 * 4,
             "route": (P.RST_RIDX + 2) * m}
        log("full width resident %s (%d rows%s, %d in the smaller child): "
            "one-kernel split %.4f ms (planes mode %.4f, twin %.2f, "
            "three-launch chain %.4f), bound %.5f ms; histogram %.4f ms (K4 "
            "planes %.4f, K4 rows %.4f, twin %.2f, index_add_ %.4f), bound "
            "%.5f ms; route "
            "gather %.4f ms (twin %.2f, index_select %.4f), bound %.5f ms"
            % (tag, m, ", depth %d" % depth if tag == "deep" else "",
               n_small, t["b7"], t["b7_planes"], t["b7_plain"],
               t["three_launch"], b["b7"] / PEAK_BYTES_PER_S * 1e3,
               t["hist"], t["hist_planes"], t["hist_rows"], t["hist_plain"],
               t["hist_library"], b["hist"] / PEAK_BYTES_PER_S * 1e3,
               t["route"], t["route_plain"], t["route_library"],
               b["route"] / PEAK_BYTES_PER_S * 1e3))
        log("full width resident %s, device ms (queued launches): %s"
            % (tag, json.dumps(dev_t)))
        if tag == "root":
            rows = {
                "one_kernel_split_resident": dict(
                    route="cuda",
                    source="lightgbm_tpu_torch/csrc/one_kernel_split.cu",
                    replaces="lightgbm_tpu/ops/partition.py:1465",
                    ms=t["b7"], device_ms=dev_t["b7"],
                    plain_ms=t["b7_plain"], library_ms=None,
                    planes_ms=t["b7_planes"],
                    planes_device_ms=dev_t["b7_planes"],
                    three_launch_ms=t["three_launch"], bytes=b["b7"],
                    ops=m + n_small * F * 5),
                "segment_histogram_resident": dict(
                    route="cuda",
                    source="lightgbm_tpu_torch/csrc/segment_histogram.cu",
                    replaces="lightgbm_tpu/ops/histogram.py:560",
                    ms=t["hist"], device_ms=dev_t["hist"],
                    plain_ms=t["hist_plain"],
                    library_ms=t["hist_library"],
                    planes_ms=t["hist_planes"], bytes=b["hist"],
                    ops=m * F * 5),
                "write_route_plane": dict(
                    route="cuda",
                    source="lightgbm_tpu_torch/csrc/resident_route.cu",
                    replaces="lightgbm_tpu/ops/partition.py:410",
                    ms=t["route"], device_ms=dev_t["route"],
                    plain_ms=t["route_plain"],
                    library_ms=t["route_library"],
                    library_device_ms=dev_t["route_library"],
                    bytes=b["route"], ops=m)}
        else:
            for name, k in (("one_kernel_split_resident", "b7"),
                            ("segment_histogram_resident", "hist"),
                            ("write_route_plane", "route")):
                rows[name].update(
                    deep_rows=m, deep_depth=depth, deep_ms=t[k],
                    deep_device_ms=dev_t[k],
                    deep_bound_ms=b[k] / PEAK_BYTES_PER_S * 1e3)
            rows["one_kernel_split_resident"]["deep_planes_ms"] = \
                t["b7_planes"]
            rows["one_kernel_split_resident"]["deep_planes_device_ms"] = \
                dev_t["b7_planes"]
            rows["write_route_plane"]["deep_library_ms"] = \
                t["route_library"]
            rows["write_route_plane"]["deep_library_device_ms"] = \
                dev_t["route_library"]
            rows["segment_histogram_resident"]["deep_planes_ms"] = \
                t["hist_planes"]
    for name, prefix in (("one_kernel_split_resident",
                          "one_kernel_resident/"),
                         ("segment_histogram_resident",
                          "histogram_resident/"),
                         ("write_route_plane", "route/")):
        if name in rows:
            rows[name]["max_abs_err"] = max(
                v for k, v in errs.items() if k.startswith(prefix))
    return rows


# ------------------------------------------------------------- fused block

#: trees per block of phase 3d's profiled block (tpu_iter_block's default)
FUSED_BLOCK = 10


def commit_state(dev, rng, L, F, B, nan=False, ties=False):
    """A seeded tree state and one-kernel outputs for split_commit: every
    table filled with random values (gains in [-1, 1) with some -inf; NaN
    gains with ``nan``; the top gain repeated at a higher slot with
    ``ties``), header rows whose parent slots, segments and depths are
    consistent with L, and outputs of random sums, bins and tables."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.ops import commit as C
    from lightgbm_tpu_torch.ops import partition as P

    st = C.tree_state(L, F, B, dev)
    out = P.split_out(F, B, dev)

    def r(*shape):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32)).to(dev)

    gain = rng.uniform(-1, 1, L).astype(np.float32)
    gain[rng.rand(L) < 0.3] = -np.inf
    if ties:
        top = int(np.argmax(gain))
        gain[(top + 1 + rng.randint(L - 1)) % L] = gain[top]
        gain[(top + L // 2) % L] = gain[top]
    if nan:
        gain[rng.randint(L, size=2)] = np.nan
    st.best_gain.copy_(torch.as_tensor(gain))
    st.best_feature.copy_(torch.as_tensor(rng.randint(F, size=L)))
    st.best_bin.copy_(torch.as_tensor(rng.randint(B, size=L)))
    st.best_kind.copy_(torch.as_tensor(rng.randint(4, size=L)))
    st.best_dl.copy_(torch.as_tensor(rng.rand(L) < 0.5))
    st.best_go.copy_(torch.as_tensor(rng.rand(L, B) < 0.5))
    for t in (st.best_ls, st.best_rs, st.best_lo, st.best_ro, st.leaf_sum,
              st.leaf_out, st.hist_pool):
        t.copy_(r(*t.shape))
    st.leaf_lower.copy_(r(L) - 2.0)
    st.leaf_upper.copy_(r(L) + 2.0)
    st.depth.copy_(torch.as_tensor(rng.randint(0, 9, size=L)))
    st.seg_tab.copy_(torch.as_tensor(np.stack(
        [rng.randint(128, 5000, L), rng.randint(0, 4000, L),
         rng.randint(0, 2, L)], axis=1)))
    st.num_splits.fill_(int(rng.randint(0, L - 1)))
    st.hdr.copy_(torch.as_tensor(np.stack(
        [rng.randint(0, 2, L), rng.randint(128, 5000, L),
         rng.randint(1, 4000, L), rng.randint(F, size=L),
         rng.randint(0, 2, L), rng.randint(1, 9, L), np.ones(L, np.int64),
         rng.randint(0, L, L)], axis=1)))
    out.lt.fill_(int(rng.randint(0, 100)))
    out.hists.copy_(r(*out.hists.shape))
    out.fout.copy_(r(18))
    out.iout.copy_(torch.as_tensor(np.concatenate(
        [rng.randint(F, size=2), rng.randint(B, size=2),
         rng.randint(4, size=2)])))
    out.bout.copy_(torch.as_tensor(rng.rand(2 + 2 * B) < 0.5))
    return st, out


#: (name, s as a fraction of L - 1 or an index, live word of header s - 1,
#: state options, max_depth, monotone)
COMMIT_CASES = (
    ("first", 0, 1, {}, -1, False),
    ("mid", 0.5, 1, {}, -1, False),
    ("mid_max_depth", 0.5, 1, {}, 4, False),
    ("mid_monotone", 0.5, 1, {}, -1, True),
    ("ties", 0.5, 1, {"ties": True}, -1, False),
    ("nan_gains", 0.5, 1, {"nan": True}, -1, True),
    ("after_stop", 0.5, 0, {}, -1, False),
    ("final", 1.0, 1, {}, 3, False),
    ("final_stopped", 1.0, 0, {}, -1, False),
)


def check_split_commit(name, st, out, s, max_depth, monotone, mono_on,
                       pooled=False):
    """split_commit (the kernel on a CUDA state) against its plain twin on
    copies of one state: every table, log, header and pair row bit-equal
    (compared as bytes, so NaN and -0.0 count); ``pooled`` the mode whose
    split pooled the children (no copy). Returns 0.0."""
    import torch
    from lightgbm_tpu_torch.ops import commit as C

    a = C.TreeState(*(t.clone() for t in st))
    b = C.TreeState(*(t.clone() for t in st))
    kw = dict(max_depth=max_depth, monotone=monotone, has_monotone=mono_on,
              pooled=pooled)
    C.split_commit(a, out, s, **kw)
    C.split_commit_plain(b, out, s, **kw)
    sync(st.hdr.device)
    for fld, x, y in zip(C.TreeState._fields, a, b):
        if not torch.equal(x.view(torch.uint8), y.view(torch.uint8)):
            raise AssertionError("%s: split_commit %s differs from its twin "
                                 "(%d of %d bytes)"
                                 % (name, fld, int(torch.count_nonzero(
                                     x.view(torch.uint8)
                                     != y.view(torch.uint8))),
                                    x.view(torch.uint8).numel()))
    return 0.0


def phase_commit_kernel(dev, rng, L=63, F=9, B=40, modes=(False,)):
    """The split commit against its twin on seeded states (COMMIT_CASES:
    the first and a middle split, max_depth cutting the children, basic
    monotone bounds, tied and NaN gains, a split after the tree stopped
    (live 0), the final commit of a tree that ran and of one that
    stopped), in each of ``modes`` (``pooled``: False the commit copies
    the children, True the split scan pooled them; keys of the pooled
    mode end in ``/pooled``)."""
    import torch
    errs = {}
    monotone = torch.as_tensor(rng.randint(-1, 2, F).astype("int8")).to(dev)
    for name, where, live, opts, max_depth, mono_on in COMMIT_CASES:
        st, out = commit_state(dev, rng, L, F, B, **opts)
        s = where if isinstance(where, int) else int(round(where * (L - 1)))
        if s > 0:
            st.hdr[s - 1, 6] = live
        for pooled in modes:
            key = "commit/%s%s" % (name, "/pooled" if pooled else "")
            errs[key] = check_split_commit(key, st, out, s, max_depth,
                                           monotone, mono_on, pooled)
    return errs


def loop_state_at(lrn, ghc, s):
    """The learner's device tree loop (built by one tree on ``ghc`` if the
    learner has none: fused blocks on host tensors take the host loop) run
    eagerly from the root through split slot ``s - 1`` on ``ghc``: the
    loop, its state before commit ``s``."""
    if lrn._loop is None:
        lrn.train_device(ghc)
    loop = lrn._loop
    loop.ghc.copy_(ghc)
    loop.fmask.fill_(True)
    loop.root()
    loop.splits(s)
    return loop


def full_width_commit(bst, dev, errs, timed=True, s=None, label=""):
    """The split commit against its twin at a full-width state: the
    fused model's learner's device loop run to commit ``s`` of a tree
    (the middle one by default) on the model's gradients (F, B and L of
    phase 3d), then commit s on copies, in the loop's mode (``pooled``
    where its split pools the children: the chain without bundles; else
    the commit copies them: B7). When ``timed``: the kernel's ms (host
    clock and device_ms), the twin's and the bound. ``label`` tells the
    check's key apart (``commit/full_width<label>``)."""
    import torch
    from lightgbm_tpu_torch.ops import commit as C

    g = bst.inner
    lrn = g.learner
    grad, hess = g.objective.get_gradients(g.train_score.score)
    ghc = torch.stack([grad, hess, torch.ones_like(grad)], dim=1)
    L = lrn.num_leaves
    tag = ("commit/full_width" if s is None
           else "commit/full_width_s%d" % s) + label
    s = L // 2 if s is None else s
    loop = loop_state_at(lrn, ghc, s)
    st, out = loop.state, loop.out
    pooled = loop.pooled
    kw = dict(max_depth=loop.commit.max_depth, monotone=lrn.meta.monotone,
              mono_on=lrn.hp.has_monotone)
    errs[tag] = check_split_commit(tag, st, out, s, kw["max_depth"],
                                   kw["monotone"], kw["mono_on"], pooled)
    if not timed:
        return {}
    a = C.TreeState(*(t.clone() for t in st))
    op = C.SplitCommit(a, out, max_depth=kw["max_depth"],
                       monotone=kw["monotone"], has_monotone=kw["mono_on"],
                       pooled=pooled)
    b = C.TreeState(*(t.clone() for t in st))
    k_ms = cuda_ms(lambda: op(s))
    k_dev = device_ms(lambda: op(s))
    p_ms = cuda_ms(lambda: C.split_commit_plain(
        b, out, s, max_depth=kw["max_depth"], monotone=kw["monotone"],
        has_monotone=kw["mono_on"], pooled=pooled), iters=5, warmup=1)
    F, B = st.hist_pool.shape[1], st.hist_pool.shape[2]
    # the function reads the L gains and the winner's row of the best
    # table and writes the log entry, leaf rows and the header; unless the
    # split pooled them, it also reads the two child histograms and writes
    # them into the pool, which then dominate
    f_bytes = (0 if pooled else 2 * 2 * F * B * 3 * 4) + L * 4 + 2 * B + 512
    log("full width split commit%s (%s): %.4f ms (device %.4f, twin %.3f) "
        "at L = %d, F = %d, B = %d, s = %d, %d blocks; byte floor %.6f ms"
        % (label, "pooled" if pooled else "copies the children", k_ms,
           k_dev, p_ms, L, F, B, s, op._blocks,
           f_bytes / PEAK_BYTES_PER_S * 1e3))
    return {"split_commit": dict(
        route="cuda", source="lightgbm_tpu_torch/csrc/split_commit.cu",
        replaces="lightgbm_tpu/learner.py:1175", status="redesigned PR 20",
        max_abs_err=max(v for k, v in errs.items()
                        if k.startswith("commit/")),
        ms=k_ms, device_ms=k_dev, plain_ms=p_ms, library_ms=None,
        bytes=f_bytes, ops=L + 64, pooled=pooled)}


def check_one_kernel_header(name, work, seg, table, kw):
    """The one-kernel split through its device header: with the parent in
    row 3 of a histogram pool it gives what the parent in row 0 gives
    (every output bit-equal, the same routed bytes), and with the live
    word 0 it writes nothing (the work buffer and every output buffer
    unchanged). Returns 0.0."""
    import torch
    from lightgbm_tpu_torch.ops import partition as P

    dev = work.device
    F, B = kw["num_feat"], kw["num_bins"]
    outs = []
    sg = torch.tensor(seg, dtype=torch.int32, device=dev)
    pair = P.split_pair(kw["sums2"], kw["outs2"], kw["lows2"], kw["ups2"])
    pool = torch.zeros((5, F, B, 3), dtype=torch.float32, device=dev)
    pool[3] = kw["parent_hist"]
    for slot, parent, live in ((0, kw["parent_hist"][None], 1),
                               (3, pool, 1), (3, pool, 0)):
        w = work.clone()
        op = P.OneKernelSplit(w, kw["meta"], kw["fmask"], kw["hp"],
                              num_bins=B, num_feat=F, cnt_max=max(seg[2], 1))
        out = P.split_out(F, B, dev)
        for t in out:
            t.copy_(torch.ones_like(t) if t.dtype == torch.bool
                    else torch.full_like(t, 7))
        hdr = P.split_header(sg, kw["left_smaller"], kw["depth"], slot, live)
        op.split(hdr, table, parent, pair, out)
        outs.append((w, out))
    sync(dev)
    (w0, o0), (w3, o3), (wz, oz) = outs
    if not torch.equal(w0, w3) or not all(
            torch.equal(x.view(torch.uint8), y.view(torch.uint8))
            for x, y in zip(o0, o3)):
        raise AssertionError("%s: the parent's pool row changes the split"
                             % name)
    if not torch.equal(wz, work) or not all(
            bool((t == (1 if t.dtype == torch.bool else 7)).all())
            for t in oz):
        raise AssertionError("%s: a live = 0 split wrote something" % name)
    return 0.0


# ------------------------------------------- the three-launch chain (slice 11)

#: (name, [src, start, cnt, col], left_smaller, live) of the chain's checks
#: over a 9000-row buffer
CHAIN_CASES = (("unaligned", [0, 128 + 13, 7001, 3], 1, 1),
               ("right_smaller", [0, 128, 9000, 0], 0, 1),
               ("one_row", [0, 128 + 8999, 1, 5], 1, 1),
               ("dead", [0, 128 + 13, 7001, 3], 1, 0))


def chain_header(seg, left_smaller, live, dev, depth=1, slot=0):
    """A split's (8,) i32 device header (ops/partition.ONE_KERNEL_HDR)."""
    import torch
    return torch.tensor(list(seg) + [left_smaller, depth, live, slot],
                        dtype=torch.int32, device=dev)


def check_chain_static(name, work, seg, table, ls, live, layout, num_bins,
                       num_feat, exact=True, resident=None, scale=None):
    """The chain's launches on a split's header with static plans sized for
    CHAIN_STATIC_ROWS (the route gather on resident, K3, then K4 or K5 of
    the smaller child from the header and the left count) against the
    per-split path with the host's segment and bounds at the counts, on
    copies of one buffer: the routed bytes, lt and the histogram's bits
    equal. A dead header (live 0) moves no byte, leaves lt and gives a
    zero histogram. Returns 0.0."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.ops import partition as P

    dev = work.device
    a, b = work.clone(), work.clone()
    hdr = chain_header(seg, ls, live, dev)
    lt = torch.full((1,), -7, dtype=torch.int32, device=dev)
    part_layout = "rows" if layout == "int8" else layout
    if resident is not None:
        P.RouteGather(a, resident, cnt_max=CHAIN_STATIC_ROWS)(hdr)
    P.SegmentPartition(a, layout=part_layout,
                       cnt_max=CHAIN_STATIC_ROWS)(hdr, table, lt)
    small = H.SegmentHistogram(
        a, layout=layout, num_bins=num_bins, num_feat=num_feat, exact=exact,
        cnt_max=CHAIN_STATIC_ROWS, resident=resident, scale=scale)(hdr, lt)
    sync(dev)
    if not live:
        if not torch.equal(a, work) or int(lt) != -7 \
                or bool((small != 0).any()):
            raise AssertionError("%s: a dead header wrote something" % name)
        return 0.0
    sg = torch.tensor(seg, dtype=torch.int32, device=dev)
    src, start, cnt, _ = seg
    bound = max(cnt, 1)
    if resident is not None:
        P.write_route_plane(b, resident, sg, bound)
        lt_b = P.partition_segment(b, P.on_route_plane(sg), table, bound)
    elif part_layout == "rows":
        lt_b = P.partition_segment_rows(b, sg, table, bound)
    else:
        lt_b = P.partition_segment(b, sg, table, bound)
    n_left = int(lt_b)
    hseg = [1 - src, start, n_left] if ls \
        else [1 - src, start + n_left, cnt - n_left]
    hs = torch.tensor(hseg, dtype=torch.int32, device=dev)
    hkw = dict(num_bins=num_bins, num_feat=num_feat,
               cnt_bound=max(hseg[2], 1))
    if layout == "int8":
        want = H.segment_histogram_q(b, hs, scale, **hkw)
    elif layout == "resident":
        want = H.segment_histogram_resident(b, resident, hs, exact=exact,
                                            **hkw)
    elif layout == "rows":
        want = H.segment_histogram_rows(b, hs, exact=exact, **hkw)
    else:
        want = H.segment_histogram(b, hs, exact=exact, **hkw)
    sync(dev)
    if int(lt) != n_left or not torch.equal(a, b):
        raise AssertionError("%s: static-plan partition differs (lt %d vs "
                             "%d, %d bytes)" % (name, int(lt), n_left,
                                                int((a != b).sum())))
    if not torch.equal(small.view(torch.int32), want.view(torch.int32)):
        raise AssertionError("%s: static-plan histogram not bit-equal"
                             % name)
    return 0.0


def chain_children(work, seg, table, kw):
    """The children's (F, B, 3) histograms of ``seg`` routed by ``table``
    through K3 + K4 + the parent subtraction (as the host loop builds
    them), on a copy of ``work``."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.ops import partition as P

    dev = work.device
    c = work.clone()
    sg = torch.tensor(seg, dtype=torch.int32, device=dev)
    bound = max(seg[2], 1)
    n_left = int(P.partition_segment(c, sg, table, bound))
    src, start, cnt = seg[:3]
    ls = kw["left_smaller"]
    hseg = [1 - src, start, n_left] if ls \
        else [1 - src, start + n_left, cnt - n_left]
    small = H.segment_histogram(c, torch.tensor(hseg, dtype=torch.int32,
                                                device=dev),
                                num_bins=kw["num_bins"],
                                num_feat=kw["num_feat"], cnt_bound=bound)
    large = kw["parent_hist"] - small
    return (small, large) if ls else (large, small)


SCAN_FIELDS = ("gain", "feature", "bin", "kind", "default_left", "go_left",
               "left_sum", "right_sum", "left_output", "right_output")


def check_split_scan(name, hists, pair, depth, meta, fmask, hp, op=None):
    """The split scan kernel (a CUDA tensor) against ``find_best_split``
    run by torch on the card on the same (2, F, B, 3) histograms, pair row
    and depth: every SplitInfo field bit-equal (compared as bytes), and a
    dead header (live 0) writes nothing. Returns 0.0."""
    import torch
    from lightgbm_tpu_torch.ops import partition as P
    from lightgbm_tpu_torch.ops.scan import SplitScan
    from lightgbm_tpu_torch.ops.split import find_best_split

    dev = hists.device
    F, B = hists.shape[1], hists.shape[2]
    op = op or SplitScan(meta, fmask, hp, num_feat=F, num_bins=B,
                         device=dev)
    out = P.split_out(F, B, dev)
    op(hists, pair, chain_header([0, 0, 0, 0], 1, 1, dev, depth), out)
    ref = find_best_split(hists, pair[0:6].view(2, 3), meta, fmask, hp,
                          parent_output=pair[6:8], leaf_lower=pair[8:10],
                          leaf_upper=pair[10:12], node_depth=depth)
    dead = P.split_out(F, B, dev)
    for t in dead:
        t.fill_(1)
    op(hists, pair, chain_header([0, 0, 0, 0], 1, 0, dev, depth), dead)
    sync(dev)
    got = out.infos()
    for fld in SCAN_FIELDS:
        x = getattr(got, fld)
        y = getattr(ref, fld).to(x.dtype)
        if not torch.equal(x.contiguous().view(torch.uint8),
                           y.contiguous().view(torch.uint8)):
            raise AssertionError("%s: split_scan %s %s vs find_best_split "
                                 "%s" % (name, fld, x.tolist()[:8],
                                         y.tolist()[:8]))
    if not all(bool((t == 1).all()) for t in dead):
        raise AssertionError("%s: a dead header's scan wrote something"
                             % name)
    return 0.0


#: phase 2's seeded fold shapes (F, B, categorical): the chain's width,
#: the ranking width (three item rounds of the cluster), the dense
#: builder's 907 and 1023 bins (fewer warps a CTA, two rounds)
FOLD_SHAPES = ((28, 255, False), (28, 255, True), (137, 255, False),
               (28, 907, False), (28, 1023, True))


def seeded_scan_state(rng, dev, F, B, cat=False, P=6):
    """Seeded scan inputs at F features of B bins: FeatureMeta with some
    features short of B bins and a movable missing bin on others (with
    ``cat``, a few categorical features of 4-40 categories under
    many-vs-many and one-vs-rest), SplitHyper, a (P, F, B, 3) pool of
    histograms on a 1/64 grid (counts integral), a smaller child below
    the parent of row 2, and a pair row of the children's sums. Returns
    (meta, hp, fmask, pool, small, pair)."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.ops.partition import split_pair
    from lightgbm_tpu_torch.ops.split import FeatureMeta, SplitHyper

    nb = np.full(F, B, np.int32)
    short = rng.rand(F) < 0.3
    nb[short] = rng.randint(2, B + 1, int(short.sum()))
    movable = (rng.rand(F) < 0.3) & (nb > 2)
    miss = np.where(movable, nb - 1, 0).astype(np.int32)
    is_cat = np.zeros(F, bool)
    hp = {"min_data_in_leaf": 5.0, "min_sum_hessian_in_leaf": 1e-3}
    if cat:
        idx = rng.choice(F, 4, replace=False)
        is_cat[idx] = True
        nb[idx] = (5, 12, 40, 3)
        movable[idx] = False
        miss[idx] = 0
        hp.update(has_categorical=True, max_cat_to_onehot=4,
                  min_data_per_group=5.0, cat_smooth=2.0)
    meta = FeatureMeta(
        num_bins=torch.as_tensor(nb).to(dev),
        movable_missing=torch.as_tensor(movable).to(dev),
        missing_bin=torch.as_tensor(miss).to(dev),
        is_categorical=torch.as_tensor(is_cat).to(dev),
        monotone=torch.zeros(F, dtype=torch.int8, device=dev),
        penalty=torch.ones(F, dtype=torch.float32, device=dev),
        cegb_coupled=torch.zeros(F, dtype=torch.float32, device=dev))
    cnt = rng.poisson(40.0, (P, F, B)).astype(np.float32)
    cnt[:, np.arange(B)[None, :] >= nb[:, None]] = 0.0
    g = np.round(rng.randn(P, F, B) * cnt * 0.2 * 64) / 64
    h = np.round(np.abs(rng.randn(P, F, B)) * cnt * 0.1 * 64) / 64
    pool = torch.as_tensor(np.stack([g, h, cnt], -1).astype(np.float32)) \
        .to(dev).contiguous()
    small = torch.as_tensor((np.stack([g[2], h[2], cnt[2]], -1)
                             * 0.375).astype(np.float32)).to(dev)
    small = torch.round(small * 64) / 64
    tot = pool[2].sum(dim=(0, 1)) / F
    sums = torch.stack([tot * 0.375, tot * 0.625])
    pair = split_pair(sums, torch.zeros(2, device=dev),
                      torch.full((2,), float("-inf"), device=dev),
                      torch.full((2,), float("inf"), device=dev))
    fmask = torch.as_tensor(rng.rand(F) < 0.9).to(dev)
    return meta, SplitHyper(**hp), fmask, pool, small.contiguous(), pair


def phase_fold_kernels(dev, rng, shapes=FOLD_SHAPES):
    """The split scan on seeded inputs at FOLD_SHAPES: fold mode (the
    sibling folded in) against the torch sequence on the card with the
    left or the right child the smaller, and a dead header
    (check_split_fold); direct mode on the same children against
    find_best_split (check_split_scan). Returns errs."""
    import types
    from lightgbm_tpu_torch.ops.scan import SplitScan, fold_children

    errs = {}
    for F, B, cat in shapes:
        meta, hp, fmask, pool, small, pair = seeded_scan_state(rng, dev, F, B,
                                                               cat)
        op = SplitScan(meta, fmask, hp, num_feat=F, num_bins=B, device=dev)
        loop = types.SimpleNamespace(split=types.SimpleNamespace(scan=op))
        tag = "F%d_B%d%s" % (F, B, "_cat" if cat else "")
        for ls in (1, 0):
            hdr = chain_header([0, 0, 0, 0], ls, 1, dev, 3, slot=2)
            key = "split_scan/fold/%s/ls%d" % (tag, ls)
            errs[key] = check_split_fold(key, loop, hdr, pair, small, pool, 3)
            key = "split_scan/direct/%s/ls%d" % (tag, ls)
            errs[key] = check_split_scan(key, fold_children(small, pool, hdr)
                                         .contiguous(), pair, 3, meta, fmask,
                                         hp, op)
    return errs


def cat_route_table(rng, rounds, F, nb, dev, frac=0.5):
    """A seeded router table (route_table_np's "tree") and its categorical
    table: about ``frac`` of the rounds categorical, each with a random
    go-left set over ``nb`` bins."""
    import types
    import numpy as np
    import torch
    from lightgbm_tpu_torch.ops.route import build_cat_table

    table = route_table_np(rng, rounds, F, "tree")
    kind = (rng.rand(rounds) < frac).astype(np.int32)
    go = rng.rand(rounds, nb) < 0.5
    log = types.SimpleNamespace(kind=torch.as_tensor(kind),
                                go_left=torch.as_tensor(go))
    return (torch.as_tensor(table).to(dev),
            build_cat_table(log).to(dev))


def check_cat_router(name, bins_t, table, cat, num_splits):
    """The router with a categorical table (route_rows_cat, a CUDA tensor)
    against its twin: leaf ids equal, and equal run to run. Returns 0.0."""
    import torch
    from lightgbm_tpu_torch.ops.route import route_rows, route_rows_plain

    dev = bins_t.device
    ns = torch.tensor([num_splits], dtype=torch.int32, device=dev)
    got = route_rows(bins_t, table, ns, cat)
    again = route_rows(bins_t, table, ns, cat)
    want = route_rows_plain(bins_t, table, ns, cat)
    sync(dev)
    id_diff(name, got, want)
    if not torch.equal(got, again):
        raise AssertionError("%s: not equal run to run" % name)
    return 0.0


def phase_chain_kernels(dev, rng):
    """The chain's kernels on the card, seeded: K3, the route gather and
    K4 / K5 on a split's header with static plans against the per-split
    path (CHAIN_CASES on the planes, rows f32, int8 and resident layouts,
    a dead header included); the split scan against find_best_split on the
    children of every SPLIT_CASES case, bit for bit; the router with a
    categorical table against its twin (a 254-round tree over 28 columns
    at 65,536 rows, 9000 rows with one column, num_splits 0)."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.learner import route_layout
    from lightgbm_tpu_torch.ops.partition import split_pair

    errs = {}
    n, nb = 9000, 64
    tables = _tables(rng, nb, dev)
    bins = torch.as_tensor(rng.randint(0, nb, (n, 10)).astype(np.uint8))
    work = seeded_work(rng, bins, dev)
    for name, seg, ls, live in CHAIN_CASES:
        key = "chain/planes/" + name
        errs[key] = check_chain_static(key, work, seg, tables["table"], ls,
                                       live, "planes", nb, 10)
    for F, quantized in ((27, False), (28, True)):
        rb = torch.as_tensor(rng.randint(0, nb, (n, F)).astype(np.uint8))
        rwork, scale = seeded_rows_work(rng, rb, dev, quantized)
        tag = "int8" if quantized else "rows"
        for name, seg, ls, live in CHAIN_CASES:
            key = "chain/%s/%s" % (tag, name)
            errs[key] = check_chain_static(key, rwork, seg, tables["table"],
                                           ls, live, tag, nb, F, scale=scale)
    rbins = torch.as_tensor(rng.randint(0, nb, (n, 8)).astype(np.uint8))
    bins_all, res, rows = seeded_resident(rng, rbins, dev)
    ghc = torch.as_tensor(np.stack([rng.randn(n), np.abs(rng.randn(n)),
                                    np.ones(n)], axis=1).astype(np.float32)
                          ).to(dev)
    slim, _ = resident_pair(dev, bins_all, res, rows, ghc, rng)
    for name, seg, ls, live in CHAIN_CASES:
        key = "chain/resident/" + name
        rseg = [seg[0], seg[1], seg[2], seg[3] % 8]
        errs[key] = check_chain_static(key, slim, rseg, tables["table"], ls,
                                       live, "resident", nb, 8,
                                       resident=res)
    for case in SPLIT_CASES:
        work_c, seg, table, kw = split_inputs(dev, split_case(case, rng))
        hl, hr = chain_children(work_c, seg, table, kw)
        pair = split_pair(kw["sums2"], kw["outs2"], kw["lows2"], kw["ups2"])
        key = "split_scan/" + case
        errs[key] = check_split_scan(key, torch.stack([hl, hr]), pair,
                                     kw["depth"], kw["meta"], kw["fmask"],
                                     kw["hp"])
    F = 28
    bt = route_layout(torch.as_tensor(rng.randint(0, nb, (65536, F))
                                      .astype(np.uint8)).to(dev))
    for name, rounds, ns in (("tree254", 254, 254), ("ns0", 254, 0),
                             ("all_cat", 60, 60)):
        table, cat = cat_route_table(rng, rounds, F, nb, dev,
                                     1.0 if name == "all_cat" else 0.5)
        key = "router_cat/" + name
        errs[key] = check_cat_router(key, bt, table, cat, ns)
    one = route_layout(torch.as_tensor(rng.randint(0, nb, (9000, 1))
                                       .astype(np.uint8)).to(dev))
    table, cat = cat_route_table(rng, 30, 1, nb, dev)
    errs["router_cat/one_column"] = check_cat_router(
        "router_cat/one_column", one, table, cat, 30)
    return errs


def chain_split_at(lrn, ghc, s):
    """The learner's device tree loop run eagerly through split slot
    ``s`` on ``ghc`` (loop_state_at ``s + 1``): the loop, slot ``s``'s
    header and pair rows, the scan's input histograms and the routing
    table."""
    loop = loop_state_at(lrn, ghc, s + 1)
    st = loop.state
    return loop, st.hdr[s], st.pair[s], loop.children(s), loop.table(s)


def fold_inputs_at(lrn, ghc, s):
    """The inputs of split slot ``s``'s scan in fold mode: the learner's
    device tree loop run eagerly through slot ``s - 1`` on ``ghc``, then
    slot ``s`` up to its scan (``pre_split``, the split's first launches).
    Returns (loop, header row, pair row, the smaller child, a copy of the
    pool before the scan)."""
    from lightgbm_tpu_torch.ops.chain import DenseSplit

    loop = loop_state_at(lrn, ghc, s)
    loop.pre_split(s)
    st = loop.state
    hdr, pair = st.hdr[s], st.pair[s]
    split = loop.split
    if isinstance(split, DenseSplit):
        small = split.small_child(hdr, loop.table(s), loop.out, s + 1)
    else:
        small = split.small_child(hdr, loop.table(s), loop.out)
    return loop, hdr, pair, small.clone(), st.hist_pool.clone()


def check_split_fold(name, loop, hdr, pair, small, pool0, s):
    """The split scan's fold mode (the kernel on CUDA tensors) against the
    torch sequence on the card (``ops/scan.split_scan_fold_plain``: the
    sibling by index_select / sub / where, the pool rows, find_best_split)
    on copies of one pool: the pool and every SplitInfo field bit-equal
    (as bytes); a dead header (live 0) writes nothing. Returns 0.0."""
    import torch
    from lightgbm_tpu_torch.ops import partition as P
    from lightgbm_tpu_torch.ops.scan import split_scan_fold_plain

    dev = small.device
    op = loop.split.scan
    F, B = small.shape[0], small.shape[1]
    outs = [P.split_out(F, B, dev) for _ in range(2)]
    pa, pb = pool0.clone(), pool0.clone()
    op.fold(small, pa, hdr, s + 1, pair, outs[0])
    split_scan_fold_plain(small, pb, hdr, s + 1, pair, outs[1], op.meta,
                          op.fmask, op.hp, op.node, op.bounds)
    dead_hdr = hdr.clone()
    dead_hdr[6] = 0
    dead = P.split_out(F, B, dev)
    for t in dead:
        t.fill_(1)
    pd = pool0.clone()
    op.fold(small, pd, dead_hdr, s + 1, pair, dead)
    sync(dev)
    if not torch.equal(pa.view(torch.uint8), pb.view(torch.uint8)):
        rows = (pa.view(torch.uint8) != pb.view(torch.uint8)).flatten(1) \
            .any(1).nonzero().flatten().tolist()
        raise AssertionError("%s: the folded pool rows %s differ from the "
                             "torch sequence's" % (name, rows[:8]))
    for fld in ("fout", "iout", "bout"):
        x, y = getattr(outs[0], fld), getattr(outs[1], fld)
        if not torch.equal(x.view(torch.uint8), y.view(torch.uint8)):
            raise AssertionError("%s: split_scan fold %s %s vs %s"
                                 % (name, fld, x.tolist()[:8],
                                    y.tolist()[:8]))
    if not torch.equal(pd, pool0) or not all(bool((t == 1).all())
                                             for t in dead):
        raise AssertionError("%s: a dead header's fold wrote something"
                             % name)
    return 0.0


def scan_call_at(lrn, ghc, s):
    """The split scan of slot ``s`` of the learner's device tree loop as
    the loop launches it: in fold mode from the slot's inputs
    (fold_inputs_at) into a copy of the pool, else on the children the
    loop's split gave it (chain_split_at). Returns (loop, call), where
    ``call(stamps=None)`` launches the scan again."""
    from lightgbm_tpu_torch.ops import partition as P

    if lrn._loop is not None and lrn._loop.pooled:
        loop, hdr, pair, small, pool0 = fold_inputs_at(lrn, ghc, s)
        pool = pool0.clone()
        F, B = small.shape[0], small.shape[1]
        o2 = P.split_out(F, B, small.device)
        op = loop.split.scan

        def call(stamps=None):
            op.fold(small, pool, hdr, s + 1, pair, o2, stamps=stamps)

        return loop, call
    loop, hdr, pair, hists, _ = chain_split_at(lrn, ghc, s)
    hists = hists.clone()
    F, B = hists.shape[1], hists.shape[2]
    o2 = P.split_out(F, B, hists.device)
    op = loop.split.scan

    def call(stamps=None):
        op(hists, pair, hdr, o2, stamps=stamps)

    return loop, call


def fold_timing(lrn, ghc, s, errs, key, tag, where):
    """The split scan of slot ``s`` in fold mode, as the chain launches
    it: check_split_fold into ``errs`` (``key/fold``), then its ms (host
    clock, device_ms) beside the torch sequence it replaces on the card
    (index_select / sub / where, the pool rows, find_best_split), on a
    copy of the pool. Returns the timings (ms, device_ms and plain_ms:
    the row's main-path figures)."""
    from lightgbm_tpu_torch.ops import partition as P
    from lightgbm_tpu_torch.ops.scan import split_scan_fold_plain

    loop, hdr, pair, small, pool0 = fold_inputs_at(lrn, ghc, s)
    errs[key + "/fold"] = check_split_fold(key + "/fold", loop, hdr, pair,
                                           small, pool0, s)
    op = loop.split.scan
    F, B = small.shape[0], small.shape[1]
    pool, poolb = pool0.clone(), pool0.clone()
    o2, o3 = P.split_out(F, B, small.device), P.split_out(F, B,
                                                          small.device)
    f_ms = cuda_ms(lambda: op.fold(small, pool, hdr, s + 1, pair, o2))
    f_dev = device_ms(lambda: op.fold(small, pool, hdr, s + 1, pair, o2))
    f_plain = cuda_ms(lambda: split_scan_fold_plain(
        small, poolb, hdr, s + 1, pair, o3, op.meta, op.fmask, op.hp,
        op.node, op.bounds), iters=5, warmup=1)
    log("chain %s at the %s: split_scan fold %.4f ms (device %.4f; the "
        "torch sequence and find_best_split %.3f)"
        % (tag, where, f_ms, f_dev, f_plain))
    return dict(ms=f_ms, device_ms=f_dev, plain_ms=f_plain, fold=True)


def full_width_chain(bst, dev, errs, tag, timed=True):
    """The chain at full width on a fused model's learner (its device tree
    loop run eagerly on the model's gradients): the split scan against
    find_best_split at the root split's children and at the tree's last
    live split (a deep leaf), bit for bit. When ``timed``: the split
    scan's ms (host clock, device_ms), the twin's (find_best_split by torch
    on the card) and its bound at both; the partition's and the smaller
    child's histogram's device ms with the loop's static plan against a
    plan sized by the segment's own count (the per-split path's) at both.
    Returns the kernels-line rows (empty unless timed)."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.ops import partition as P
    from lightgbm_tpu_torch.ops.split import find_best_split

    g = bst.inner
    lrn = g.learner
    grad, hess = g.objective.get_gradients(g.train_score.score)
    if grad.dim() > 1:
        grad, hess = grad[:, 0], hess[:, 0]
    ghc = torch.stack([grad, hess, torch.ones_like(grad)], dim=1)
    L = lrn.num_leaves
    loop = loop_state_at(lrn, ghc, L - 1)
    live = loop.state.hdr[:, 6].cpu()
    deep = max(s for s in range(L - 1) if int(live[s]) == 1)
    out = {}
    for where, s in (("root", 0), ("deep", deep)):
        loop, hdr, pair, hists, table = chain_split_at(lrn, ghc, s)
        op = loop.split.scan
        key = "split_scan/%s/%s" % (tag, where)
        errs[key] = check_split_scan(key, hists.clone(), pair, hdr[5],
                                     lrn.meta, loop.fmask, lrn.hp, op)
        if not timed:
            if loop.pooled:
                fl = fold_inputs_at(lrn, ghc, s)
                errs[key + "/fold"] = check_split_fold(key + "/fold", *fl, s)
            continue
        F, B = hists.shape[1], hists.shape[2]
        o2 = P.split_out(F, B, dev)
        k_ms = cuda_ms(lambda: op(hists, pair, hdr, o2))
        k_dev = device_ms(lambda: op(hists, pair, hdr, o2))
        p_ms = cuda_ms(lambda: find_best_split(
            hists, pair[0:6].view(2, 3), lrn.meta, loop.fmask, lrn.hp,
            parent_output=pair[6:8], leaf_lower=pair[8:10],
            leaf_upper=pair[10:12], node_depth=hdr[5]), iters=5, warmup=1)
        src, start, cnt = (int(v) for v in hdr[:3].cpu())
        lt = loop.out.lt.clone()
        n_left = int(lt)
        ls = int(hdr[4]) != 0
        hseg = [1 - src, start, n_left] if ls \
            else [1 - src, start + n_left, cnt - n_left]
        hs = torch.tensor(hseg, dtype=torch.int32, device=dev)
        work = loop.work
        sg = hdr[:4].clone()
        part = loop.split.partition
        hist = loop.split.histogram
        lt2 = torch.empty_like(lt)
        st_part = device_ms(lambda: part(hdr, table, lt2))
        hkw = dict(num_bins=hist.num_bins, num_feat=hist.num_feat,
                   cnt_bound=max(hseg[2], 1))
        if loop.layout == "rows":
            own_part = device_ms(lambda: P.partition_segment_rows(
                work, sg, table, max(cnt, 1)))
        elif loop.layout == "resident":
            own_part = device_ms(lambda: P.partition_segment(
                work, P.on_route_plane(sg), table, max(cnt, 1)))
        else:
            own_part = device_ms(lambda: P.partition_segment(
                work, sg, table, max(cnt, 1)))
        st_hist = device_ms(lambda: hist(hdr, lt))
        if hist.layout == "int8":
            own_hist = device_ms(lambda: H.segment_histogram_q(
                work, hs, hist.scale, **hkw))
        elif hist.layout == "resident":
            own_hist = device_ms(lambda: H.segment_histogram_resident(
                work, hist.resident, hs, exact=hist.exact, **hkw))
        elif hist.layout == "rows":
            own_hist = device_ms(lambda: H.segment_histogram_rows(
                work, hs, exact=hist.exact, **hkw))
        else:
            own_hist = device_ms(lambda: H.segment_histogram(
                work, hs, exact=hist.exact, **hkw))
        log("chain %s at the %s (%d rows, smaller child %d): split_scan "
            "%.4f ms (device %.4f, find_best_split %.3f); partition device "
            "%.4f static / %.4f own plan; histogram (%s) device %.4f static "
            "/ %.4f own plan" % (tag, where, cnt, hseg[2], k_ms, k_dev, p_ms,
                                 st_part, own_part, hist.layout, st_hist,
                                 own_hist))
        out[where] = dict(rows=cnt, small_rows=hseg[2], ms=k_ms,
                          device_ms=k_dev, plain_ms=p_ms,
                          direct_ms=k_ms, direct_device_ms=k_dev,
                          partition_static_device_ms=st_part,
                          partition_own_plan_device_ms=own_part,
                          histogram_static_device_ms=st_hist,
                          histogram_own_plan_device_ms=own_hist,
                          histogram=hist.layout, F=F, B=B)
        if loop.pooled:
            out[where].update(fold_timing(lrn, ghc, s, errs, key, tag,
                                          where))
    if not timed:
        return {}
    deep_row = out["deep"]
    F, B = deep_row["F"], deep_row["B"]
    # the scan reads the two (F, B, 3) histograms and the pair row and
    # writes two SplitInfo rows; ~10 operations for each of its 2 x 4 x F
    # x B candidates
    # fold mode also reads the parent's row and writes both children
    hist_bytes = (4 if deep_row.get("fold") else 2) * F * B * 12
    return {"split_scan": dict(
        route="cuda", source="lightgbm_tpu_torch/csrc/split_scan.cu",
        replaces="lightgbm_tpu/ops/split.py:find_best_split (XLA; no "
                 "pallas_call)", status="redesigned PR 20",
        max_abs_err=max(v for k, v in errs.items()
                        if k.startswith("split_scan/")),
        ms=deep_row["ms"], device_ms=deep_row["device_ms"],
        plain_ms=deep_row["plain_ms"], library_ms=None,
        bytes=hist_bytes + 48 + 2 * (64 + B),
        ops=2 * 4 * F * B * 10, shapes=out)}


#: phase 3e: rows, trees and leaves of the mixed run (HIGGS-like columns,
#: two categorical columns, three one-hot blocks that EFB bundles)
MIXED_ROWS = 200_000
MIXED_TREES = 8
MIXED_PARAMS = {"objective": "binary", "max_bin": 255, "num_leaves": 63,
                "verbosity": -1, "max_cat_to_onehot": 4,
                "min_data_per_group": 50, "tpu_split_kernel": "off"}


def mixed_data(seed, n):
    """(X, y, categorical columns): 28 HIGGS-like columns, a 4-category
    column (one-vs-rest splits under max_cat_to_onehot = 4), a
    24-category one (many-vs-many) and three one-hot blocks of 8 sparse
    columns that EFB bundles; labels from a seeded logistic model over
    all of them."""
    import numpy as np
    rng = np.random.RandomState(seed + 31)
    X = higgs_like(rng, n)
    c4 = rng.randint(0, 4, n)
    c24 = rng.randint(0, 24, n)
    blocks, z = [], X[:, :4] @ np.array([0.6, -0.4, 0.3, 0.2])
    for b in range(3):
        ids = rng.randint(0, 8, n)
        oh = np.zeros((n, 8))
        oh[np.arange(n), ids] = 1.0
        blocks.append(oh)
        z = z + 0.4 * (ids % (b + 2) == 0)
    z = z + 0.8 * (c4 == 2) + 0.6 * np.isin(c24, (1, 5, 8, 13, 21)) \
        - 0.5 * np.isin(c24, (2, 3, 17))
    y = (rng.rand(n) < 1 / (1 + np.exp(-(z - z.mean())))).astype(np.float64)
    X = np.concatenate([X, c4[:, None], c24[:, None]] + blocks, axis=1)
    return X, y, [X.shape[1] - 26, X.shape[1] - 25]


def phase_mixed(dev, seed, card, rows=MIXED_ROWS, trees=MIXED_TREES,
                timed=True):
    """Phase 3e: categorical and EFB data through the device tree loop.
    ``mixed_data`` at ``rows`` rows, MIXED_PARAMS (three launches), trained
    in fused blocks (each tree one graph replay: the chain, the commit
    with the bundle column map, the router with its categorical table) and
    per iteration (a user callback; the per-split host loop and torch's
    scan): the model strings must be byte-equal, the model must hold
    one-vs-rest and many-vs-many splits and the dataset EFB bundles; the
    fused run launches split_scan and route_rows_cat. Then the split scan
    against find_best_split at the model's root and a deep leaf
    (full_width_chain), and the categorical router (a CUDA tensor) against
    its twin on the model's trees over the training rows and a 65,536-row
    rung, and (``timed``) its ms over the
    training rows. Returns (fused booster, launch counts, summary, check
    errors, the categorical router's kernels-line row)."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import kernels
    from lightgbm_tpu_torch.ops.predict import tree_to_bin_log
    from lightgbm_tpu_torch.ops.route import build_cat_table, build_route_table

    X, y, cats = mixed_data(seed, rows + 65536)
    Xr, X, y = X[rows:], X[:rows], y[:rows]
    params = dict(MIXED_PARAMS, device_type=dev.type)

    def dataset():
        ds = lgt.Dataset(X, label=y, categorical_feature=cats,
                         params=params)
        ds.construct()
        return ds

    train = dataset()
    sync(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    fused = lgt.train(dict(params), train, trees)
    sync(dev)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    g = fused.inner
    loop = g.learner._loop
    if g._fused is None or (dev.type == "cuda" and (loop is None
                                                    or loop.graph is None)):
        raise AssertionError("phase 3e: training did not take the device "
                             "tree loop's graph")
    if g.learner.bundle is None:
        raise AssertionError("phase 3e: the dataset has no EFB bundle")
    t1 = time.perf_counter()
    eager = lgt.train(dict(params), dataset(), trees,
                      callbacks=[lambda env: None])
    sync(dev)
    eager_wall = time.perf_counter() - t1
    text_f, text_e = fused.model_to_string(), eager.model_to_string()
    ovr = sum(1 for t in g.models for c in t.cat_threshold.values()
              if len(c) == 1)
    mvm = sum(1 for t in g.models for c in t.cat_threshold.values()
              if len(c) > 1)
    log("phase 3e (%s): %d trees x %d leaves on %d rows x %d columns (%d "
        "bundles), fused %.1f ms/tree, per iteration %.1f ms/tree; %d "
        "one-vs-rest and %d many-vs-many splits; models %s; launches %s"
        % (card, trees, params["num_leaves"], rows, X.shape[1],
           g.learner.bins.shape[1], wall / trees * 1e3,
           eager_wall / trees * 1e3, ovr, mvm,
           "byte-equal" if text_f == text_e else "DIFFER", counts))
    if text_f != text_e:
        raise AssertionError("phase 3e: the fused model differs from the "
                             "per-iteration model")
    if not ovr or not mvm:
        raise AssertionError("phase 3e: want one-vs-rest and many-vs-many "
                             "splits, got %d and %d" % (ovr, mvm))
    if dev.type == "cuda":
        want = {"split_scan": trees * (params["num_leaves"] - 1),
                "route_rows_cat": trees, "route_rows": 0}
        if any(counts.get(k, 0) != v for k, v in want.items()):
            raise AssertionError("phase 3e launches %s, want %s"
                                 % (counts, want))
    errs = {}
    lrn = g.learner
    # the split scan with categorical items at the root and a deep leaf
    full_width_chain(fused, dev, errs, "mixed", timed=False)
    rung = lgt.Dataset(Xr, label=np.zeros(len(Xr)), reference=train)
    rung_t = g._valid_bins_t(rung.construct())
    for i, tree in enumerate(g.models[:3]):
        lg = tree_to_bin_log(tree, g.train_set, dev)
        table, cat = build_route_table(lg, lrn.bundle), build_cat_table(lg)
        for where, bt in (("train", lrn.bins_t), ("rung65536", rung_t)):
            key = "router_cat/mixed_tree%d_%s" % (i, where)
            errs[key] = check_cat_router(key, bt, table, cat,
                                         int(lg.num_splits[0]))
    summary = dict(trees=trees, rows=rows, wall_per_tree_ms=wall / trees
                   * 1e3, per_iteration_wall_per_tree_ms=eager_wall / trees
                   * 1e3, one_vs_rest=ovr, many_vs_many=mvm,
                   capture_ms=loop.capture_ms if loop is not None else None,
                   launches=counts)
    row = {}
    if timed and dev.type == "cuda":
        from lightgbm_tpu_torch.ops.route import route_rows, route_rows_plain
        cat_trees = [t for t in g.models if t.cat_threshold]
        lg = tree_to_bin_log(cat_trees[0], g.train_set, dev)
        table, cat = build_route_table(lg, lrn.bundle), build_cat_table(lg)
        bt = lrn.bins_t
        k_ms = cuda_ms(lambda: route_rows(bt, table, lg.num_splits, cat))
        k_dev = device_ms(lambda: route_rows(bt, table, lg.num_splits, cat))
        p_ms = cuda_ms(lambda: route_rows_plain(bt, table, lg.num_splits,
                                                cat), iters=3, warmup=1)
        # the bins read once, the tables, the leaf ids written; two
        # operations a walk step (~the tree's depth a row)
        ids = route_rows(bt, table, lg.num_splits, cat)[:rows]
        t0_ = cat_trees[0]
        depth = torch.as_tensor(t0_.leaf_depths()[
            t0_.to_split_arrays()["leaf_of_slot"]]).to(dev)
        steps = int(depth[ids.long()].sum())
        log("categorical router over the %d training rows (%d columns, %d "
            "rounds): %.4f ms (device %.4f), twin %.3f ms"
            % (rows, bt.shape[0], int(lg.num_splits[0]), k_ms, k_dev, p_ms))
        row = {"route_rows_cat": dict(
            route="cuda", source="lightgbm_tpu_torch/csrc/route_rows.cu",
            replaces="lightgbm_tpu/learner.py:1560 (the categorical branch "
                     "of assign_leaves' fori_loop; no pallas_call)",
            max_abs_err=max(v for k, v in errs.items()
                            if k.startswith("router_cat/")),
            ms=k_ms, device_ms=k_dev, plain_ms=p_ms, library_ms=None,
            bytes=bt.numel() + table.numel() * 4 + cat.numel() * 4
            + rows * 4, ops=2 * steps)}
    return fused, counts, summary, errs, row


def auc_np(y, p):
    """ROC AUC of scores ``p`` for 0/1 labels ``y`` (ties share ranks)."""
    from scipy.stats import rankdata
    r = rankdata(p)
    pos = y > 0
    n1, n0 = int(pos.sum()), int((~pos).sum())
    return float((r[pos].sum() - n1 * (n1 + 1) / 2) / (n1 * n0))


def profile_block(dev, train, leaves, extra, k=FUSED_BLOCK):
    """One fused block of ``k`` trees (after a warm-up block, which also
    captures the graph) under torch.profiler: the device's busy share of
    the block's wall. Returns a dict; busy is None when the profiler saw
    no device activity."""
    import torch
    import lightgbm_tpu_torch as lgt
    from torch.profiler import ProfilerActivity, profile

    bst = lgt.Booster(train_params(dev, leaves, extra), train)
    bst.inner.train_block(k)
    bst.inner.finish_fused("profile")
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bst.inner.train_block(k)
        bst.inner.finish_fused("profile")
        sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, calls = {}, {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if us and ev.key not in by_name:
            by_name[ev.key] = us / 1e3
            calls[ev.key] = ev.count
    kern = {k_: v for k_, v in by_name.items()
            if not k_.startswith("cuda") and not k_.startswith("aten::")}
    busy = sum(kern.values())
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:8]
    # the device ops a tree (kernels, copies, fills: the graph's nodes that
    # ran) and those of the chain's former sibling ops, by kernel name
    per_tree = {name: sum(calls[k_] for k_ in kern if any(
        p in k_ for p in pats)) / k for name, pats in SIBLING_KERNELS}
    per_tree["device_ops"] = sum(calls[k_] for k_ in kern) / k
    loop = bst.inner.learner._loop
    nodes = graph_nodes(loop) if loop is not None and loop.cuda else None
    log("profile fused block %s: %d trees, wall %.1f ms (%.2f ms/tree), "
        "device busy %.1f ms (%.1f%%); top kernels %s; a tree: %s; graph "
        "nodes a tree %s"
        % (json.dumps(extra), k, wall_ms, wall_ms / k, busy,
           100.0 * busy / wall_ms, ", ".join("%s %.2f" % kv for kv in top),
           ", ".join("%s %.1f" % kv for kv in per_tree.items()),
           nodes if nodes is not None else "not measured"))
    return dict(wall_ms=wall_ms, device_busy_ms=busy if kern else None,
                top=top, per_tree=per_tree, graph_nodes=nodes)


#: kernel-name patterns of the torch ops the chain ran a slot for the
#: sibling before the scan took it over (index_select, sub, where)
SIBLING_KERNELS = (("index_select", ("index_select", "indexSelect")),
                   ("sub", ("CUDAFunctor_add", "sub_kernel")),
                   ("where", ("where_kernel",)))


def graph_nodes(loop):
    """The nodes of one tree of a device tree loop as a CUDA graph: a
    capture of ``grow()`` kept as a graph (never replayed), counted by
    the driver's cuGraphGetNodes; a dict of the total and the kernel
    nodes, or None (with the reason logged) where that fails."""
    import ctypes
    import torch
    from lightgbm_tpu_torch.ops import kernels

    try:
        g = torch.cuda.CUDAGraph(keep_graph=True)
        with kernels.capture_launches():
            with torch.cuda.graph(g, capture_error_mode="relaxed"):
                loop.grow()
        cu = ctypes.CDLL("libcuda.so.1")
        handle = ctypes.c_void_p(g.raw_cuda_graph())
        n = ctypes.c_size_t(0)
        rc = cu.cuGraphGetNodes(handle, None, ctypes.byref(n))
        if rc != 0:
            raise RuntimeError("cuGraphGetNodes: %d" % rc)
        nodes = (ctypes.c_void_p * n.value)()
        rc = cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n))
        kinds = {}
        for nd in nodes:
            t = ctypes.c_int(0)
            cu.cuGraphNodeGetType(ctypes.c_void_p(nd), ctypes.byref(t))
            kinds[t.value] = kinds.get(t.value, 0) + 1
        g.reset()
        # CU_GRAPH_NODE_TYPE_KERNEL = 0, MEMCPY = 1, MEMSET = 2
        return {"total": int(n.value), "kernel": kinds.get(0, 0),
                "memcpy": kinds.get(1, 0), "memset": kinds.get(2, 0)}
    except (RuntimeError, OSError, AttributeError, TypeError) as exc:
        log("graph nodes: not measured (%s)" % exc)
        return None


def phase_one_kernel_header(dev, rng):
    """check_one_kernel_header on phase_one_kernel's numerical case: an
    unaligned segment and the whole buffer."""
    errs = {}
    work, seg, table, kw = split_inputs(dev, split_case("numerical", rng))
    for name, sg in (("unaligned", [0, 128 + 13, 7001, seg[3]]),
                     ("whole", seg)):
        key = "one_kernel_header/%s" % name
        errs[key] = check_one_kernel_header(
            key, work, sg, table, segment_split(work, sg, table, kw))
    return errs


def phase_fused(dev, data, trees, leaves, per_iter, args, card, errs,
                profile=True):
    """Phase 3d: the device tree loop at full width. Phase 3b's data
    through ``lightgbm_tpu_torch.train`` with no valid set and no callback
    (fused blocks; each tree one replay of the learner's CUDA graph: the
    root, (split commit, split) x (leaves - 1), a final commit and the
    router), with ONE_KERNEL_PARAMS and RESIDENT_PARAMS (the one-kernel
    split), TRAIN_PARAMS (``tpu_split_kernel=off``: the three-launch chain,
    K3 + K4 + split_scan) and QUANT_PARAMS (the chain on the rows layout
    with int8: K3 rows + K5 + split_scan, the dither drawn inside the
    graph from the tree's key). Launch counts are zeroed just before each
    run and read just after: every split slot's launches trees x (leaves -
    1) times (splits plus no-op tails), split_commit trees x leaves, the
    root histogram and the router once a tree. The models must hash to
    ONE_KERNEL_MODEL_SHA256 (planes, resident), PLANES_MODEL_SHA256 (three
    launches) and QUANT_MODEL_SHA256 (quantized) at the default sizes: the
    per-iteration models of phases 3b, 3 and 4. Valid AUC from ``predict``
    of the one-kernel models must equal phase 3b's (``per_iter
    ["predict_auc"]``). Prints the wall per tree against ``per_iter``
    (phase 3b's summary), the launches per split slot and per tree, the
    graph's capture ms and replay launches and (``profile``) the busy share
    of one profiled block; checks the split scan at the chain models' root
    and a deep leaf (full_width_chain, into ``errs``). Returns (planes
    booster, {tag: launch counts}, summary, the chain's kernel rows)."""
    import hashlib
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import kernels

    X, y, Xv, yv = data
    summary = {}
    counts_by = {}
    chain_rows = {}
    keep = None
    L1 = leaves - 1
    for tag, extra, want in (("planes", ONE_KERNEL_PARAMS,
                              ONE_KERNEL_MODEL_SHA256),
                             ("resident", RESIDENT_PARAMS,
                              ONE_KERNEL_MODEL_SHA256),
                             ("three_launch", {}, PLANES_MODEL_SHA256),
                             ("quantized", QUANT_PARAMS,
                              QUANT_MODEL_SHA256)):
        params = train_params(dev, leaves, extra)
        train = lgt.Dataset(X, label=y, params=params)
        train.construct()
        sync(dev)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        bst = lgt.train(params, train, trees)
        sync(dev)
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        g = bst.inner
        if g._fused is None:
            raise AssertionError("phase 3d %s: training did not take the "
                                 "fused path" % tag)
        text = bst.model_to_string()
        s = dict(trees=trees, wall_s=wall, wall_per_tree_ms=wall / trees
                 * 1e3, model_sha256=hashlib.sha256(text.encode())
                 .hexdigest(), splits=sum(t.num_leaves - 1
                                          for t in g.models))
        check_model_sha("fused %s" % tag, s, args, want)
        loop = g.learner._loop
        slot = {"planes": ("one_kernel_split",),
                "resident": ("one_kernel_split_resident",),
                "three_launch": ("partition_segment", "split_scan"),
                "quantized": ("partition_segment_rows", "split_scan")}[tag]
        root = {"planes": "segment_histogram",
                "resident": "segment_histogram_resident",
                "three_launch": "segment_histogram",
                "quantized": "segment_histogram_q"}[tag]
        want_counts = {k: trees * L1 for k in slot}
        want_counts.update(split_commit=trees * leaves, route_rows=trees)
        want_counts[root] = trees * (1 if tag in ("planes", "resident")
                                     else leaves)
        if tag in ("planes", "resident"):
            want_counts.update(partition_segment=0, split_scan=0)
        if dev.type == "cuda":
            if any(counts.get(k, 0) != v for k, v in want_counts.items()):
                raise AssertionError("fused %s launches %s, want %s"
                                     % (tag, counts, want_counts))
            if loop is None or loop.graph is None:
                raise AssertionError("fused %s: no device tree loop "
                                     "graph" % tag)
            s["capture_ms"] = loop.capture_ms
            s["replay_launches"] = loop.replay_launches
        # a tree: the slots, then the root histogram, the final commit and
        # the router
        s["launches_per_tree"] = sum(counts.values()) / trees
        s["launches_per_split"] = (s["launches_per_tree"] - 3) / L1
        auc = auc_np(yv, bst.predict(Xv))
        s["valid_auc"] = auc
        same = tag not in ("planes", "resident") \
            or auc == per_iter["predict_auc"]
        log("fused %s (%s): %d trees x %d leaves on %d rows in %.2f s "
            "(%.1f ms/tree; per-iteration phase 3b %.1f ms/tree), %d splits;"
            " graph capture %s ms; launches per split slot %s, per tree %s;"
            " valid auc from predict %.7f (phase 3b %.7f); launches %s"
            % (tag, card, trees, leaves, len(X), wall,
               s["wall_per_tree_ms"], per_iter["wall_per_tree_ms"],
               s["splits"], s.get("capture_ms"),
               s.get("launches_per_split"), s.get("launches_per_tree"), auc,
               per_iter["predict_auc"], counts))
        if not same:
            raise AssertionError("fused %s valid auc %.7f vs phase 3b %.7f"
                                 % (tag, auc, per_iter["predict_auc"]))
        if profile and dev.type == "cuda":
            s["profile"] = profile_block(dev, train, leaves, extra)
        if tag == "three_launch":
            crow = full_width_commit(bst, dev, errs,
                                     timed=dev.type == "cuda",
                                     label="/chain")
            if crow:
                s["commit_pooled"] = crow["split_commit"]
                s["breakdown"] = scan_commit_breakdown(bst, dev)
        if tag in ("three_launch", "quantized"):
            rows = full_width_chain(bst, dev, errs, tag,
                                    timed=dev.type == "cuda")
            if rows:
                s["chain_shapes"] = rows["split_scan"]["shapes"]
                if tag == "three_launch":
                    chain_rows = rows
                else:
                    chain_rows["split_scan"]["shapes"] = dict(
                        three_launch=chain_rows["split_scan"]["shapes"],
                        quantized=rows["split_scan"]["shapes"])
        summary[tag] = s
        counts_by[tag] = counts
        if tag == "planes":
            keep = bst
        del bst
    p, r = summary["planes"], summary["resident"]
    if p["model_sha256"] != r["model_sha256"]:
        raise AssertionError("fused resident model differs from planes")
    return keep, counts_by, summary, chain_rows


def phase_serve(bst, train, rng, binned_rows):
    """The main path; returns (outputs to check, launch counts)."""
    import numpy as np
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import kernels
    from lightgbm_tpu_torch.serve import (MicroBatcher, PredictServer,
                                          PredictSession)

    reqs = {n: higgs_like(rng, n) for n in REQUEST_ROWS}
    mb_rows = [higgs_like(rng, 1 + int(rng.randint(0, 64)))
               for _ in range(64)]
    http_rows = [higgs_like(rng, 16) for _ in range(3)]
    Xb = higgs_like(rng, binned_rows)
    t0 = time.perf_counter()
    binned = lgt.Dataset(Xb, reference=train).construct()
    log("serve: binned %d rows on the host in %.1f s"
        % (binned_rows, time.perf_counter() - t0))

    out = {"reqs": reqs, "mb_rows": mb_rows, "http_rows": http_rows,
           "Xb": Xb}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    sess = PredictSession(bst)
    out["session"] = {n: sess.predict(X) for n, X in reqs.items()}
    with MicroBatcher(PredictSession(bst), max_batch_rows=4096) as mb:
        futs = [None] * len(mb_rows)

        def submit(i):
            futs[i] = mb.submit(mb_rows[i])

        ths = [threading.Thread(target=submit, args=(i,))
               for i in range(len(mb_rows))]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=60)
        out["batcher"] = [f.result(timeout=120) for f in futs]
    server = PredictServer(bst, port=0, buckets=(16, 256))
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        host, port = server.address
        out["http"] = []
        for X in http_rows:
            req = urllib.request.Request(
                "http://%s:%d/predict" % (host, port),
                data=json.dumps({"rows": X.tolist()}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                out["http"].append(json.loads(r.read())["predictions"])
    finally:
        server.shutdown()
        server.close()
        th.join(timeout=30)
    t1 = time.perf_counter()
    out["binned"] = sess.predict_binned(binned)
    t2 = time.perf_counter()
    counts = kernels.launch_counts()
    log("serve: requests+batcher+http %.2f s, predict_binned(%d) %.2f s, "
        "launches %s" % (t1 - t0, binned_rows, t2 - t1, counts))
    out["binned_ds"] = binned
    return out, counts


class TwinPredict:
    """Predictions of ``bst`` by the plain twin on its device: the raw
    rows through ``ops/predict.predict_raw_impl`` over the booster's pack
    (plain torch, no kernel), then the session's output transform."""

    def __init__(self, bst):
        from lightgbm_tpu_torch.serve import PredictSession

        g = bst.inner
        self.session = PredictSession(bst, forest="off")
        self.pack, self.has_cat, self.has_linear, _ = g._packed_model(
            0, len(g.models) // g.num_tree_per_iteration)
        self.K = g.num_tree_per_iteration

    def predict(self, X, chunk=65536):
        import numpy as np
        import torch
        from lightgbm_tpu_torch.ops.predict import predict_raw_impl

        X = np.ascontiguousarray(X, np.float32)
        raw = []
        for lo in range(0, len(X), chunk):
            x = torch.from_numpy(X[lo:lo + chunk]).to(self.session.device)
            s = predict_raw_impl(x, self.pack, num_class=self.K,
                                 has_cat=self.has_cat,
                                 has_linear=self.has_linear)
            raw.append(s.to("cpu", torch.float64).numpy()
                       .reshape(len(x), -1))
        return self.session.finalize(np.concatenate(raw))


def check_serve(bst, out):
    """Every main-path answer against the plain twin on the card
    (TwinPredict: raw thresholds, plain torch) and a small input against
    the host walk."""
    import numpy as np
    from lightgbm_tpu_torch.serve import PredictSession

    plain = TwinPredict(bst)
    errs = {}
    for n, X in out["reqs"].items():
        errs["session/%d" % n] = check_scores(
            "session/%d" % n, out["session"][n], plain.predict(X))
    errs["batcher"] = check_scores(
        "batcher", np.concatenate(out["batcher"]),
        plain.predict(np.concatenate(out["mb_rows"])))
    errs["http"] = check_scores(
        "http", np.concatenate([np.asarray(p) for p in out["http"]]),
        plain.predict(np.concatenate(out["http_rows"])))
    head = 65536
    errs["binned/plain"] = check_scores(
        "binned/plain", out["binned"][:head], plain.predict(out["Xb"][:head]))
    errs["binned/forest"] = check_scores(
        "binned/forest", out["binned"], PredictSession(bst).predict(out["Xb"]))
    # host reference: the numpy tree walk on a small input
    X = out["reqs"][256]
    g = bst.inner
    raw = sum(t.predict(X) for t in g.models) + g.init_scores[0]
    ref = 1.0 / (1.0 + np.exp(-raw))
    errs["host_walk"] = check_scores("host_walk", out["session"][256], ref)
    if out["binned"].shape != (len(out["Xb"]),):
        raise AssertionError("predict_binned shape %s"
                             % (out["binned"].shape,))
    return errs


def phase_timings(bst, out, dev, errs, rows, forest_shapes):
    """Kernel vs plain ms and bound at the main path's shapes, added to
    ``rows`` (which may already hold the training kernels' rows); the
    forest kernel's from ``forest_shapes`` (full_width_forest)."""
    import torch
    from lightgbm_tpu_torch.ops.forest import forest_predict_plain
    from lightgbm_tpu_torch.ops.predict import tree_to_bin_log
    from lightgbm_tpu_torch.ops.route import (build_route_table, route_rows,
                                              route_rows_plain)

    g = bst.inner
    fp, has_cat, _, _ = g._forest_model(0, len(g.models))
    # forest at the top rung (one 65536-row dispatch), as full_width_forest
    # timed it; its plain twin here
    top = forest_shapes["rung65536"]
    b, _ = bin_rows(g.train_set, out["reqs"][65536])
    bins = torch.from_numpy(b).to(dev)
    p_ms = cuda_ms(lambda: forest_predict_plain(bins, None, fp,
                                                has_cat=has_cat),
                   iters=3, warmup=1)
    rows["forest_predict"] = dict(
        route="cuda", source="lightgbm_tpu_torch/csrc/forest_predict.cu",
        replaces="lightgbm_tpu/ops/forest.py:268",
        max_abs_err=max(v for k, v in errs.items()
                        if k.startswith("forest")),
        ms=top["ms"], device_ms=top["device_ms"], plain_ms=p_ms,
        bytes=top["bytes"], ops=top["ops"], shapes=forest_shapes)
    # router at the binned shape: one tree over the 2M-row matrix
    bd = out["binned_ds"]
    dbins = g._valid_bins(bd)
    dbt = g._valid_bins_t(bd)
    t0 = g.models[0]
    lg = tree_to_bin_log(t0, bd, dev)
    table = build_route_table(lg, None)
    got = route_rows(dbt, table, lg.num_splits)
    want = route_rows_plain(dbt, table, lg.num_splits)
    torch.cuda.synchronize()
    errs["router/full_width"] = float(id_diff("router/full_width", got, want))
    r_ms = cuda_ms(lambda: route_rows(dbt, table, lg.num_splits))
    rp_ms = cuda_ms(lambda: route_rows_plain(dbt, table, lg.num_splits),
                    iters=3, warmup=1)
    leaf_of_slot = t0.to_split_arrays()["leaf_of_slot"]
    depth = torch.as_tensor(t0.leaf_depths()[leaf_of_slot]).to(dev)
    r_steps = int(depth[got[:bd.num_data].long()].sum())
    r_bytes = dbins.numel() + table.numel() * 4 + bd.num_data * 4
    rows["route_rows"] = dict(
        route="cuda", source="lightgbm_tpu_torch/csrc/route_rows.cu",
        replaces="lightgbm_tpu/ops/route.py:88",
        max_abs_err=max(v for k, v in errs.items()
                        if k.startswith("router/")),
        ms=r_ms, plain_ms=rp_ms, bytes=r_bytes,
        ops=2 * r_steps)
    for name, r in rows.items():
        bound_row(name, r)
    return rows


def bound_row(name, r):
    """Turn a kernels-line row's ``bytes`` and ``ops`` into ``bound_ms``
    (the larger of bytes over PEAK_BYTES_PER_S and operations over
    PEAK_SCALAR_OPS_PER_S) and ``bound_by``, and log it."""
    t_bytes = r.pop("bytes") / PEAK_BYTES_PER_S * 1e3
    t_ops = r.pop("ops") / PEAK_SCALAR_OPS_PER_S * 1e3
    r["bound_ms"] = max(t_bytes, t_ops)
    r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    r.setdefault("library_ms", None)
    log("timing %s: kernel %.4f ms, plain %.3f ms, bound %.5f ms (%s)%s"
        % (name, r["ms"], r["plain_ms"], r["bound_ms"], r["bound_by"],
           ", three-launch path %.4f ms" % r["three_launch_ms"]
           if "three_launch_ms" in r else ""))
    return r


# ------------------------------------------------------------ ranking phase

#: phase 3f: bench.py's MSLR-like ranking workload (2.27M rows x 137
#: features, ~120-document queries, five grades), cut from the
#: reference's 500 trees to RANK_TREES fused trees; rows, width, leaves and
#: bins stay full
RANK_ROWS = 2_270_000
RANK_FEATURES = 137
RANK_TREES = 20
#: per-iteration trees with the valid set, byte-equal to the first fused
#: ones, and fused rank_xendcg trees
RANK_PER_ITER_TREES = 3
XENDCG_TREES = 5
RANK_PARAMS = {"objective": "lambdarank", "num_leaves": 255, "max_bin": 255,
               "learning_rate": 0.1, "verbosity": -1, "metric": ["ndcg"],
               "eval_at": [10], "tpu_iter_block": 10}
#: the extra lambda-kernel queries beside the training set's: a 5,000- and
#: a 1,100-document query (past RANK_SMEM_DOCS: the global-memory path), a
#: single document, one all-zero-label query, an empty one and a few
#: ordinary ones
RANK_EXTRA_SIZES = (5000, 1, 50, 0, 1100, 37, 220, 8)
#: f32 operations of one (higher, lower) lambda pair, exp counted as one:
#: the score difference and its orientation, sigma * d, exp, 1 + e and its
#: reciprocal (p), |delta discount| and |delta gain| (2 each), |delta NDCG|
#: (2), lambda (2), hessian (4) and the four accumulations
LAMBDA_PAIR_OPS = 22


def mslr_like(n, f=RANK_FEATURES, docs_per_query=120, seed=11):
    """(X, y, group): ``bench.py``'s ``make_mslr_like``: Gaussian
    features, a linear relevance with noise cut into five grades by its
    global quantiles (as MSLR-WEB30K's), query sizes max(20, N(120, 25))
    until the rows run out."""
    import numpy as np
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    w = rng.randn(f) / np.sqrt(f)
    rel = X @ w + 0.5 * rng.randn(n)
    edges = np.quantile(rel, [0.55, 0.75, 0.9, 0.97])
    y = np.digitize(rel, edges).astype(np.float64)
    sizes = []
    left = n
    while left > 0:
        s = min(left, max(20, int(rng.normal(docs_per_query, 25))))
        sizes.append(s)
        left -= s
    return X.astype(np.float64), y, np.asarray(sizes, dtype=np.int64)


def rank_datasets(dev, rows, params):
    """(train, valid) Datasets of the MSLR-like set: the valid set is the
    last ~10% of the queries, cut on a query boundary."""
    import numpy as np
    import lightgbm_tpu_torch as lgt
    t0 = time.perf_counter()
    made = "beside the build" if ("mslr_like", rows) in _PREMADE else None
    X, y, group = premade(("mslr_like", rows), mslr_like, rows)
    made = made or "in %.1f s" % (time.perf_counter() - t0)
    cut = len(group) - len(group) // 10
    r = int(group[:cut].sum())
    t1 = time.perf_counter()
    train = lgt.Dataset(X[:r], label=y[:r], group=group[:cut],
                        params=dict(params, device_type=dev.type))
    train.construct()
    valid = lgt.Dataset(X[r:], label=y[r:], group=group[cut:],
                        reference=train)
    valid.construct()
    log("rank data: %d rows x %d features, %d queries (%d train, %d "
        "valid; sizes %d-%d, mean %.1f), made %s, binned in %.1f s"
        % (len(X), X.shape[1], len(group), cut, len(group) - cut,
           group.min(), group.max(), group.mean(), made,
           time.perf_counter() - t1))
    return train, valid


def query_ids(t):
    """(N,) i64 query of each row of RankTables ``t``."""
    import torch
    sizes = (t.qb[1:] - t.qb[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(t.num_queries, device=t.qb.device), sizes)


def check_lambdas(name, t, score, weight=None):
    """The lambda kernel against its twin on the same scores: NaN in the
    same rows (none where the scores are finite), and each other row's
    grad (hess) within LAMBDA_RTOL of its query's largest finite |grad|
    (hess) of the twin. Returns the largest |diff|."""
    import torch
    from lightgbm_tpu_torch.ops.rank import (LAMBDA_RTOL,
                                             lambdarank_gradients,
                                             lambdarank_gradients_plain)
    g, h = lambdarank_gradients(score, t, weight)
    gp, hp = lambdarank_gradients_plain(score, t, weight)
    sync(score.device)
    qid = query_ids(t)

    def query_max(x):
        x = torch.where(torch.isnan(x), torch.zeros_like(x), x.abs())
        return torch.zeros(t.num_queries, dtype=x.dtype,
                           device=x.device).scatter_reduce_(
            0, qid, x, "amax")[qid]

    if not (torch.equal(torch.isnan(g), torch.isnan(gp))
            and torch.equal(torch.isnan(h), torch.isnan(hp))):
        raise AssertionError("%s: NaN in other rows than the twin's (%d "
                             "and %d grad rows)" % (
                                 name, int(torch.isnan(g).sum()),
                                 int(torch.isnan(gp).sum())))
    if bool(torch.isfinite(score).all()) and not (
            torch.isfinite(g).all() and torch.isfinite(h).all()):
        raise AssertionError("%s: non-finite lambdas" % name)
    num = ~torch.isnan(gp) & ~torch.isnan(hp)
    eg = torch.where(num, (g - gp).abs(), torch.zeros_like(g))
    eh = torch.where(num, (h - hp).abs(), torch.zeros_like(h))
    bad = (eg > LAMBDA_RTOL * query_max(gp)) | (eh > LAMBDA_RTOL
                                                  * query_max(hp))
    if bool(bad.any()):
        raise AssertionError("%s: %d rows beyond %g of their query's "
                             "largest value (max |diff| grad %.3g, hess "
                             "%.3g)" % (name, int(bad.sum()), LAMBDA_RTOL,
                                        float(eg.max()), float(eh.max())))
    return float(max(eg.max(), eh.max()))


def lambda_pairs(score, t):
    """The (higher, lower) pairs that these scores' lambdas need: the
    higher side in its query's top min(truncation_level, n) ranks, the
    two gains different (for the operation bound)."""
    import torch
    from lightgbm_tpu_torch.ops.rank import bucket_tensors
    total = 0
    for p_b, k_b, safe, valid, gains, _ in bucket_tensors(t, score.device):
        s = torch.where(valid, score[safe], float("-inf"))
        order = torch.argsort(-s, dim=1, stable=True)
        g = torch.gather(gains, 1, order)
        v = torch.gather(valid, 1, order)
        once = torch.arange(p_b, device=s.device)[None, :] \
            > torch.arange(k_b, device=s.device)[:, None]
        m = (g[:, :k_b, None] != g[:, None, :]) & v[:, :k_b, None] \
            & v[:, None, :] & once[None]
        total += int(m.sum())
    return total


def rank_objective(dev, sizes, rng, params=None, weighted=False):
    """A LambdarankNDCG objective on seeded labels for queries of
    ``sizes`` (all labels 0, so the inverse max DCG is 0, where a size is
    50). The boundaries are set on the metadata directly, since a group
    size of 0 is refused there and the objective takes an empty query."""
    import numpy as np
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.dataset import Metadata
    from lightgbm_tpu_torch.objective import create_objective
    sizes = np.asarray(sizes, np.int64)
    n = int(sizes.sum())
    y = rng.randint(0, 5, n).astype(np.float64)
    qb = np.concatenate([[0], np.cumsum(sizes)])
    for q in np.flatnonzero(sizes == 50):
        y[qb[q]:qb[q + 1]] = 0.0
    w = rng.uniform(0.5, 2.0, n) if weighted else None
    obj = create_objective(Config.from_params(
        dict(objective="lambdarank", **(params or {}))))
    md = Metadata(n, label=y, weight=w)
    md.query_boundaries = qb.astype(np.int32)
    obj.init(md, dev)
    return obj


def rank_nan_scores(rng, t):
    """Seeded scores of RankTables ``t``'s rows with NaN in a few: the
    first row, two rows of each query of 20-47 documents (where the JAX
    package's bucket pads to 48, so its NaN ranks lie past the padding)
    and three of the largest query's rows, the last of them -NaN."""
    import numpy as np
    qb = t.qb.cpu().numpy()
    s = rng.randn(int(qb[-1]))
    sizes = np.diff(qb)
    picks = [qb[0]]
    for q in np.flatnonzero((sizes >= 20) & (sizes < 48)):
        picks += list(qb[q] + rng.choice(sizes[q], 2, replace=False))
    big = int(np.argmax(sizes))
    picks += list(qb[big] + rng.choice(sizes[big], min(3, sizes[big]),
                                       replace=False))
    s[np.asarray(picks, np.int64)] = np.nan
    s[picks[-1]] = -np.nan
    return s


def phase_rank_kernels(dev, rng):
    """The lambda kernel against its twin on RANK_EXTRA_SIZES queries: the
    all-tied scores of iteration 0, seeded scores, scores on a coarse grid
    (many ties), seeded scores with a few NaN (rank_nan_scores); the
    default settings, weights, the norm off with a truncation of 300
    (above the short queries' lengths, below the long ones'), and a
    truncation of 40 (between the 37-document query's numeric count and
    its bucket's 48). Returns the check errors."""
    import numpy as np
    import torch
    errs = {}
    for tag, params, weighted in (
            ("default", None, False), ("weighted", None, True),
            ("no_norm_trunc300", {"lambdarank_norm": False,
                                  "lambdarank_truncation_level": 300},
             False),
            ("trunc40", {"lambdarank_truncation_level": 40}, False)):
        obj = rank_objective(dev, RANK_EXTRA_SIZES, rng, params, weighted)
        n = obj.num_data
        for case, s in (("tied", np.zeros(n)), ("seeded", rng.randn(n)),
                        ("grid", np.round(rng.randn(n) * 4) / 4),
                        ("nan", rank_nan_scores(rng, obj.tables))):
            score = torch.as_tensor(s.astype(np.float32)).to(dev)
            key = "lambdas/%s/%s" % (tag, case)
            errs[key] = check_lambdas(key, obj.tables, score, obj.weight)
    return errs


def check_prng_card_vs_host(dev, key, shape):
    """The threefry bits and uniforms drawn on ``dev`` bit-equal to the
    host's; the Gumbel values within 2 ulps of max(|g|, 1)."""
    import torch
    from lightgbm_tpu_torch import prng
    tiny = float(torch.finfo(torch.float32).tiny)
    for what, fn in (("bits", lambda d: prng.random_bits(key, shape,
                                                         device=d)),
                     ("uniform", lambda d: prng.uniform(
                         key, shape, device=d, minval=tiny))):
        a, b = fn(dev).cpu(), fn(torch.device("cpu"))
        if what == "uniform":
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            raise AssertionError("prng %s: card and host differ at %d of %d"
                                 % (what, int((a != b).sum()), a.numel()))
    a = prng.gumbel(key, shape, device=dev).cpu()
    b = prng.gumbel(key, shape, device=torch.device("cpu"))
    ulp = torch.finfo(torch.float32).eps * torch.clamp(b.abs(), min=1.0)
    err = float(((a - b).abs() / ulp).max())
    if err > 2.0:
        raise AssertionError("prng gumbel: card and host %.1f ulps apart"
                             % err)
    return err


def untrained_ndcg10(ds):
    """NDCG@10 of all-equal scores on a constructed Dataset (each query in
    its own order): the floor a trained ranker must beat."""
    import numpy as np
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.metric import NDCGMetric
    md = ds.construct().metadata
    m = NDCGMetric(Config.from_params({"eval_at": [10]}))
    return m.eval(np.zeros(md.num_data), md.label, None,
                  md.query_boundaries)[0][1]


def model_text(bst, num_iteration):
    """``model_to_string(num_iteration)`` without its best_iteration line
    (the fused path stores its whole run's count there)."""
    return "\n".join(ln for ln in bst.model_to_string(num_iteration)
                     .splitlines() if not ln.startswith("best_iteration="))


def phase_rank(dev, card, rows=RANK_ROWS, trees=RANK_TREES,
               per_iter=RANK_PER_ITER_TREES, xendcg_trees=XENDCG_TREES,
               timed=True, seed=0, extra=None):
    """Phase 3f: LambdaRank at full width on the card. MSLR-like data
    (mslr_like, ``rows`` rows) with RANK_PARAMS through ``train``: fused
    blocks, the lambdas one launch of ``rank_lambdas`` a tree, each tree
    one replay of the device tree loop's graph. Launch counts are zeroed
    just before and read just after the ``trees``-tree run. Prints the
    wall per tree (the first block apart, from a run of one block, and the
    graph's capture ms), the ``auto`` resolution of each knob and the
    train NDCG@10; a second run's model sha256 must equal the first's.
    Then ``per_iter`` trees per iteration with the valid set: their model
    string byte-equal to the first ``per_iter`` fused trees' (best
    iteration aside), the valid NDCG@10 after each. The lambda kernel
    against its twin at this shape (all-tied scores, seeded scores, the
    trained model's scores) and on RANK_EXTRA_SIZES (phase_rank_kernels),
    timed when ``timed``; the threefry bits and uniforms of rank_xendcg's
    draw card vs host, and ``xendcg_trees`` fused rank_xendcg trees.
    ``extra`` params go on RANK_PARAMS (a small rehearsal). Returns
    (summary, launch counts of the main run, the kernels-line row, check
    errors)."""
    import hashlib
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import prng
    from lightgbm_tpu_torch.obs import telemetry
    from lightgbm_tpu_torch.ops import kernels
    from lightgbm_tpu_torch.ops.rank import (lambdarank_gradients,
                                             lambdarank_gradients_plain)

    params = dict(RANK_PARAMS, device_type=dev.type, **(extra or {}))
    train, valid = rank_datasets(dev, rows, params)
    n = train.construct().num_data
    summary = dict(rows=n, features=train.construct().num_total_features,
                   queries=len(train.get_group()), trees=trees)

    def fused_run(k):
        sync(dev)
        t0 = time.perf_counter()
        bst = lgt.train(dict(params), train, k)
        sync(dev)
        return bst, time.perf_counter() - t0

    # the one-time set-up of a Dataset's first booster (the binned matrix
    # to the card and its router layout, cached on the Dataset; the
    # objective's tables), timed apart from the runs
    sync(dev)
    t0 = time.perf_counter()
    lgt.Booster(dict(params), train)
    sync(dev)
    setup = time.perf_counter() - t0
    telemetry.reset()
    kernels.reset_launch_counts()
    bst, wall = fused_run(trees)
    counts = kernels.launch_counts()
    g = bst.inner
    loop = g.learner._loop
    if g._fused is None or (dev.type == "cuda" and (loop is None
                                                    or loop.graph is None)):
        raise AssertionError("phase 3f: training did not take the fused "
                             "device tree loop")
    auto = {r["knob"]: r["value"]
            for r in telemetry.records("auto_resolution")}
    if dev.type == "cuda":
        # the lambdas once a tree; each tree's graph: the split slots (B7
        # or the chain's scan), the commit and the router
        want = {"rank_lambdas": trees, "route_rows": trees,
                "split_commit": trees * params["num_leaves"]}
        splits = counts.get("one_kernel_split", 0) \
            + counts.get("split_scan", 0)
        if any(counts.get(k, 0) != v for k, v in want.items()) \
                or splits != trees * (params["num_leaves"] - 1):
            raise AssertionError("phase 3f launches %s, want %s and %d "
                                 "split slots" % (counts, want, trees
                                                  * (params["num_leaves"]
                                                     - 1)))
    text = bst.model_to_string()
    sha = hashlib.sha256(text.encode()).hexdigest()
    ndcg = dict((m, v) for _, m, v, _ in bst.eval_train())["ndcg@10"]
    bst2, wall2 = fused_run(trees)
    sha2 = hashlib.sha256(bst2.model_to_string().encode()).hexdigest()
    del bst2
    block = int(params["tpu_iter_block"])
    first, first_wall = fused_run(block)
    del first
    # a run of one block against the second full run: the later blocks
    steady = (wall2 - first_wall) / max(trees - block, 1)
    summary.update(
        setup_s=setup, wall_s=wall, wall_per_tree_ms=wall / trees * 1e3,
        second_run_wall_s=wall2,
        second_run_wall_per_tree_ms=wall2 / trees * 1e3,
        first_block_wall_s=first_wall,
        later_blocks_wall_per_tree_ms=steady * 1e3,
        capture_ms=getattr(loop, "capture_ms", None), auto=auto,
        train_ndcg10=ndcg, model_sha256=sha, second_model_sha256=sha2,
        splits=sum(t.num_leaves - 1 for t in g.models), launches=counts)
    log("phase 3f (%s): %d lambdarank trees x %d leaves on %d rows x %d "
        "features in %.2f s (%.1f ms/tree), again in %.2f s (%.1f "
        "ms/tree); the first block of %d alone %.2f s (graph capture %s "
        "ms), later blocks %.1f ms/tree; the Dataset's first booster's "
        "set-up %.2f s apart; train ndcg@10 %.5f; auto %s; launches %s"
        % (card, trees, params["num_leaves"], n, summary["features"], wall,
           summary["wall_per_tree_ms"], wall2,
           summary["second_run_wall_per_tree_ms"], block, first_wall,
           summary["capture_ms"], steady * 1e3, setup, ndcg, auto, counts))
    if sha != sha2:
        raise AssertionError("phase 3f: two fused runs gave different "
                             "models")
    floor = untrained_ndcg10(train)
    summary["untrained_train_ndcg10"] = floor
    if not (np.isfinite(ndcg) and floor < ndcg <= 1.0):
        raise AssertionError("phase 3f: train ndcg@10 %.4f (untrained "
                             "%.4f)" % (ndcg, floor))

    evals = {}
    sync(dev)
    t0 = time.perf_counter()
    eager = lgt.train(dict(params), train, per_iter, valid_sets=[valid],
                      callbacks=[lgt.record_evaluation(evals)])
    sync(dev)
    eager_wall = time.perf_counter() - t0
    same = model_text(eager, per_iter) == model_text(bst, per_iter)
    curve = evals["valid_0"]["ndcg@10"]
    summary.update(per_iteration_wall_per_tree_ms=eager_wall / per_iter
                   * 1e3, valid_ndcg10=curve)
    log("phase 3f per iteration with the valid set: %d trees in %.2f s "
        "(%.1f ms/tree); model %s the first %d fused trees'; valid "
        "ndcg@10 after each tree %s"
        % (per_iter, eager_wall, eager_wall / per_iter * 1e3,
           "byte-equal to" if same else "DIFFERS from", per_iter,
           ", ".join("%.5f" % v for v in curve)))
    if not same:
        raise AssertionError("phase 3f: per-iteration trees differ from "
                             "the fused ones")
    vfloor = untrained_ndcg10(valid)
    summary["untrained_valid_ndcg10"] = vfloor
    if not all(np.isfinite(v) and v <= 1.0 for v in curve) \
            or curve[-1] <= vfloor:
        raise AssertionError("phase 3f: valid ndcg@10 %s (untrained %.4f)"
                             % (curve, vfloor))
    del eager

    # the lambda kernel against its twin at this shape
    obj = g.objective
    t = obj.tables
    rng = np.random.RandomState(seed + 41)
    scores = {"tied": torch.zeros(n, dtype=torch.float32, device=dev),
              "seeded": torch.as_tensor(rng.randn(n).astype(np.float32))
              .to(dev),
              "after_%d_trees" % trees: g.train_score.score.clone()}
    errs = {}
    for case, s in scores.items():
        key = "lambdas/full_width/%s" % case
        errs[key] = check_lambdas(key, t, s, obj.weight)
    errs.update(phase_rank_kernels(dev, rng))

    # the tree loop's kernels at this width (F = 137: B7 works on 149
    # planes) against their twins, on the trained model's gradients: B7 at
    # the root and at a deep leaf of the first tree, the split commit
    # after the root, in the middle and at the last split, the router over
    # the training and valid rows. Keys under "rank/".
    fw = {}
    # (the split sums are held to the f32 summation bound over the
    # winner's bins: the lambdas cancel, compare_split_info)
    b7 = full_width_one_kernel(bst, dev, fw, timed=timed
                               and dev.type == "cuda", cancelling=True)
    idx, depth = deep_leaf_rows(bst, dev)
    _, planes, seg, table, kw = model_segment(bst, dev, idx, depth)
    fw["one_kernel/deep"] = check_one_kernel("one_kernel/deep", planes,
                                             seg, table, kw,
                                             cancelling=True)
    del planes
    for s in (1, params["num_leaves"] // 2, params["num_leaves"] - 1):
        full_width_commit(bst, dev, fw, timed=False, s=s)
    full_width_route(bst, valid.construct(), dev, fw, timed=False)
    errs.update(("rank/" + k, v) for k, v in fw.items())
    if b7:
        summary["one_kernel_split_root"] = {
            k: b7["one_kernel_split"][k]
            for k in ("ms", "device_ms", "plain_ms", "three_launch_ms",
                      "bytes")}
    log("phase 3f: B7 at %d features (root, a %d-row leaf at depth %d), "
        "the split commit (3 states) and the router equal to their twins: "
        "%s" % (summary["features"], int(idx.numel()), depth,
                ", ".join("%s %.3g" % kv for kv in sorted(fw.items()))))

    # rank_xendcg: the draws card vs host, then fused trees on the card
    key = prng.fold_in(prng.PRNGKey(5), 3)
    shape = (t.num_queries, obj.P)
    errs["prng/gumbel_ulps"] = check_prng_card_vs_host(dev, key, shape)
    xparams = dict(params, objective="rank_xendcg")
    xtrain = lgt.Dataset(train.data, label=train.label, group=train.group,
                         params=xparams)
    xtrain.construct()
    sync(dev)
    t0 = time.perf_counter()
    xb = lgt.train(dict(xparams), xtrain, xendcg_trees)
    sync(dev)
    xwall = time.perf_counter() - t0
    xndcg = dict((m, v) for _, m, v, _ in xb.eval_train())["ndcg@10"]
    if xb.inner._fused is None or not np.isfinite(xndcg) or xndcg <= floor:
        raise AssertionError("phase 3f: rank_xendcg fused %s, ndcg@10 %.4f"
                             % (xb.inner._fused is not None, xndcg))
    summary.update(xendcg_trees=xendcg_trees, xendcg_wall_per_tree_ms=xwall
                   / xendcg_trees * 1e3, xendcg_train_ndcg10=xndcg)
    log("phase 3f rank_xendcg: draws of shape %s bit-equal card vs host "
        "(gumbel within %.1f ulps); %d fused trees in %.2f s (%.1f "
        "ms/tree), train ndcg@10 %.5f; lambda checks max |diff| %.3g"
        % (shape, errs["prng/gumbel_ulps"], xendcg_trees, xwall,
           xwall / xendcg_trees * 1e3, xndcg,
           max(v for k, v in errs.items() if k.startswith("lambdas/"))))
    del xb, xtrain

    row = {}
    if timed and dev.type == "cuda":
        s = scores["after_%d_trees" % trees]
        w = obj.weight
        k_ms = cuda_ms(lambda: lambdarank_gradients(s, t, w))
        k_dev = device_ms(lambda: lambdarank_gradients(s, t, w))
        p_ms = cuda_ms(lambda: lambdarank_gradients_plain(s, t, w),
                       iters=3, warmup=1)
        p_dev = device_ms(lambda: lambdarank_gradients_plain(s, t, w),
                          iters=3, warmup=1)
        pairs = lambda_pairs(s, t)
        # each row's score, gain (and weight) read and grad, hess written
        # once; the boundaries, inverse max DCGs and discounts
        f_bytes = n * (16 + (4 if w is not None else 0)) \
            + t.qb.numel() * 4 + t.inv_max_dcg.numel() * 4 \
            + t.discount.numel() * 4
        log("lambda kernel at %d rows, %d queries: %.4f ms (device %.4f), "
            "twin %.3f ms (device %.3f); %d pairs; byte floor %.5f ms, "
            "operation floor %.5f ms"
            % (n, t.num_queries, k_ms, k_dev, p_ms, p_dev, pairs,
               f_bytes / PEAK_BYTES_PER_S * 1e3,
               pairs * LAMBDA_PAIR_OPS / PEAK_SCALAR_OPS_PER_S * 1e3))
        row = {"rank_lambdas": dict(
            route="cuda", source="lightgbm_tpu_torch/csrc/rank_lambdas.cu",
            replaces="lightgbm_tpu/objective.py:595 "
                     "(LambdarankNDCG._bucket_lambdas; XLA, no pallas_call)",
            max_abs_err=max(v for k, v in errs.items()
                            if k.startswith("lambdas/")),
            ms=k_ms, device_ms=k_dev, plain_ms=p_ms, plain_device_ms=p_dev,
            library_ms=None, pairs=pairs, bytes=f_bytes,
            ops=pairs * LAMBDA_PAIR_OPS)}
    return summary, counts, row, errs


# ------------------------------------------------------- objectives phase

#: phase 3g: each objective beyond binary, L2 and softmax, on the card and on
#: the host: OBJECTIVE_ROWS HIGGS-shaped rows, OBJECTIVE_TREES trees of
#: OBJECTIVE_LEAVES leaves (cut from 255 to keep the host runs short; the
#: trees cut from 4 to keep the whole script near its time with phase 3j)
OBJECTIVE_ROWS = 200_000
OBJECTIVE_TREES = 3
OBJECTIVE_LEAVES = 63
OBJECTIVES = ("regression_l1", "huber", "fair", "quantile", "mape",
              "poisson", "gamma", "tweedie", "multiclassova",
              "cross_entropy", "cross_entropy_lambda")
#: the train metric card vs host: |diff| <= OBJECTIVE_METRIC_TOL *
#: max(1, |host|) (histogram sums in another order may flip a near-tie
#: split)
OBJECTIVE_METRIC_TOL = 1e-3


def objective_labels(objective, X, rng):
    """Labels valid for ``objective`` from the HIGGS signal of ``X``:
    continuous for the L1 family, positive for the log links (counts for
    Poisson and Tweedie, gamma noise for Gamma), three classes for OVA,
    probabilities in [0, 1] for the cross-entropies; on a 1/1024 grid."""
    import numpy as np
    s = higgs_signal(X)
    s = (s - s.mean()) / s.std()
    if objective in ("poisson", "tweedie"):
        y = rng.poisson(np.exp(0.5 * s)).astype(np.float64)
    elif objective == "gamma":
        y = np.exp(0.5 * s) * rng.gamma(4.0, 0.25, len(s)) + 1e-3
    elif objective == "multiclassova":
        y = np.digitize(s + 0.5 * rng.randn(len(s)), [-0.5, 0.5])
    elif objective.startswith("cross_entropy"):
        y = 1.0 / (1.0 + np.exp(-1.5 * s))
    else:
        y = s + 0.5 * rng.randn(len(s))
    return np.round(np.asarray(y, np.float64) * 1024.0) / 1024.0


def phase_objectives(dev, data, card, rows=OBJECTIVE_ROWS,
                     trees=OBJECTIVE_TREES, leaves=OBJECTIVE_LEAVES,
                     seed=0):
    """Phase 3g: every objective of OBJECTIVES trains on the card and on
    the host (the plain twins) from the same rows (the first ``rows`` of
    the HIGGS-shaped training data) with labels from objective_labels:
    fused blocks, or per iteration for the objectives with leaf renewal
    (L1, quantile, MAPE). The splits that agree (split_agreement) and the
    train metric card vs host within OBJECTIVE_METRIC_TOL. Returns
    {objective: summary}."""
    import numpy as np
    import lightgbm_tpu_torch as lgt
    X = data[0][:rows]
    rng = np.random.RandomState(seed + 43)
    out = {}

    def check_for(obj, ca, ta, mname, va, renew):
        def check(host):
            vh, th = host["eval_train"][0][2], host["seconds"]
            agree, total, first = split_agreement(ca, host["splits"])
            log("phase 3g %s (%s): %d rows x %d trees x %d leaves (%s); %d "
                "of %d splits agree (first tree %d of %d); train %s card "
                "%.7f host %.7f; card %.1f s, host %.1f s"
                % (obj, card, rows, trees, leaves,
                   "per iteration" if renew else "fused", agree, total,
                   first[0], first[1], mname, va, vh, ta, th))
            if not (np.isfinite(va) and abs(va - vh)
                    <= OBJECTIVE_METRIC_TOL * max(1.0, abs(vh))):
                raise AssertionError("phase 3g %s: train %s card %.6f host "
                                     "%.6f" % (obj, mname, va, vh))
            out[obj].update(host=vh, splits_agree=agree, splits=total,
                            host_s=th)
        return check

    for obj in OBJECTIVES:
        y = objective_labels(obj, X, rng)
        params = dict(objective=obj, num_leaves=leaves, max_bin=255,
                      verbosity=-1, device_type=dev.type)
        if obj == "multiclassova":
            params["num_class"] = 3
        ds = lgt.Dataset(X, label=y, params=params)
        t0 = time.perf_counter()
        bst = lgt.train(params, ds, trees)
        sync(dev)
        ev = bst.eval_train()
        ta, mname, va = time.perf_counter() - t0, ev[0][1], ev[0][2]
        renew = bst.inner.objective.need_renew
        fused = getattr(bst.inner, "_fused", None) is not None
        if fused == renew:
            raise AssertionError("phase 3g %s: fused %s with renewal %s"
                                 % (obj, fused, renew))
        out[obj] = dict(metric=mname, card=va, card_s=ta, fused=not renew)
        ca = tree_splits(bst)
        del bst, ds
        host_run(params, X, y, trees,
                 check_for(obj, ca, ta, mname, va, renew))
    return out


# ------------------------------------------------------------ options phase

#: phase 3h: fused trees of each configuration at full width (phase 3's
#: data, 255 leaves, 255 bins), the first per-iteration trees compared with
#: the first fused ones, and the card-vs-host runs (3g's size)
OPTIONS_TREES = 10
OPTIONS_PER_ITER_TREES = 2
OPTIONS_HOST_ROWS = 200_000
OPTIONS_HOST_TREES = 3
OPTIONS_HOST_LEAVES = 63
#: card vs host, train logloss (the agreement phase 3g shows)
OPTIONS_METRIC_TOL = 2e-7
#: GOSS compaction bit for bit against the dense path on the card, on
#: gradients drawn in full float32 (check_goss_compact_bits): rows, and the
#: in-bag share
GOSS_BITS_ROWS = 65536
GOSS_BITS_INBAG = 0.25
#: the node inputs kernel with more constraint sets than one word of bits
#: a feature holds (its compat scratch has no bound)
NODE_MANY_SETS = 300
#: the interaction constraint sets: the lepton, missing energy, jets 1-2
#: and the masses; jets 3-4 and the masses (every column in one at least;
#: the forced splits' features all lie in the first)
OPTIONS_SETS = "[%s],[%s]" % (
    ",".join(str(f) for f in list(range(13)) + list(range(21, 28))),
    ",".join(str(f) for f in range(13, 28)))
#: CEGB: a split costs 1e-5 a row of its leaf (20 at the 2M-row root, 0.1
#: at a 10,000-row leaf), a feature 2.0 until the model first splits on it
#: (gains at 2M rows run to the thousands: the trees keep their leaves)
OPTIONS_CEGB = {"cegb_penalty_split": 1e-5,
                "cegb_penalty_feature_coupled": [2.0] * HIGGS_FEATURES}
#: three levels of forced splits (7), BFS: (feature, threshold) of the
#: root, its left and right children, and their children left to right
OPTIONS_FORCED = ((25, 1.0), (0, 0.9), (1, 0.0), (21, 1.0), (3, 0.9),
                  (26, 1.0), (8, 0.5))


def forced_json(path):
    """Write OPTIONS_FORCED as a forced-splits JSON tree to ``path``."""
    nodes = [{"feature": f, "threshold": t} for f, t in OPTIONS_FORCED]
    for i, node in enumerate(nodes):
        if 2 * i + 1 < len(nodes):
            node["left"] = nodes[2 * i + 1]
        if 2 * i + 2 < len(nodes):
            node["right"] = nodes[2 * i + 2]
    with open(path, "w") as f:
        json.dump(nodes[0], f)
    return path


def options_configs(forced_file):
    """The configurations of phase 3h: (a) by-node sampling and
    extra-trees, (b) interaction constraints, CEGB and forced splits, (c)
    GOSS with compaction on and off, (d) forced splits alone at default
    knobs (the one-kernel split on the card). TRAIN_PARAMS pins the
    three-launch split; (d) drops that pin."""
    return {
        "bynode_extra": {"feature_fraction_bynode": 0.5,
                         "extra_trees": True},
        "constraints_cegb_forced": dict(
            OPTIONS_CEGB, interaction_constraints=OPTIONS_SETS,
            forcedsplits_filename=forced_file),
        "goss_compact_on": dict(GOSS_PARAMS, tpu_goss_compact="on"),
        "goss_compact_off": dict(GOSS_PARAMS, tpu_goss_compact="off"),
        "forced_one_kernel": {"forcedsplits_filename": forced_file,
                              "tpu_split_kernel": "auto"},
    }


def check_node_draws(name, dev, rng, F, L=255, S=3):
    """The node inputs kernel (``ops/node.node_inputs`` on CUDA tensors)
    against its twin run by torch on the same card tensors
    (``node_inputs_plain``: prng.uniform's threefry, the stable double
    argsort, the constraint sets' masks, the CEGB formula): masks, bins and
    penalties bit-equal for several (round, leaf) pairs, the leaf read from
    a header word or given, and a dead live word writes nothing. Returns
    0.0."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.ops import node as N
    from lightgbm_tpu_torch.ops.split import SplitHyper
    from lightgbm_tpu_torch.prng import PRNGKey

    def t(a):
        return torch.as_tensor(a).to(dev)

    opts = N.NodeOptions(kth=max(1, F // 2), extra_trees=True, extra_seed=6,
                         sets=t(rng.rand(S, F) < 0.6), cegb=True)
    hp = SplitHyper(cegb_tradeoff=0.9, cegb_penalty_split=1e-5,
                    use_cegb=True)
    kw = dict(opts=opts, fmask=t(rng.rand(F) < 0.9),
              num_bins=t(rng.randint(1, 256, F).astype(np.int32)),
              coupled=t(rng.rand(F).astype(np.float32) * 3), hp=hp,
              sums=t((rng.rand(2, 3) * 1e5).astype(np.float32)),
              used=t(rng.rand(L, F) < 0.1), tree_used=t(rng.rand(F) < 0.5))
    keys = N.node_keys(PRNGKey(int(rng.randint(2 ** 31))), 6,
                       torch.zeros(4, dtype=torch.int64, device=dev))
    for r, leaf, leaf1 in ((0, 0, 0), (0, 0, 1), (5, 3, 6), (253, 200, 254)):
        for lf in (leaf, t(np.array([leaf], np.int32))):
            a, b = N.node_buf(opts, F, dev), N.node_buf(opts, F, dev)
            N.node_inputs(a, keys, r, lf, leaf1, 2, **kw)
            N.node_inputs_plain(b, keys, r, lf, leaf1, 2, **kw)
            sync(dev)
            for x, y in zip(a.rows(2), b.rows(2)):
                if not torch.equal(x.view(torch.uint8), y.view(torch.uint8)):
                    raise AssertionError("%s: node_inputs differs from its "
                                         "twin at r %d, leaf %d" % (name, r,
                                                                    leaf))
    dead = N.node_buf(opts, F, dev)
    for x in dead:
        x.fill_(1)
    N.node_inputs(dead, keys, 1, 0, 1, 2,
                  live=torch.zeros(1, dtype=torch.int32, device=dev), **kw)
    sync(dev)
    if not all(bool((x == 1).all()) for x in dead):
        raise AssertionError("%s: a dead live word wrote node inputs" % name)
    return 0.0


def check_split_scan_node(name, op, hists, pair, hdr, meta, hp):
    """The split scan kernel with the children's own node inputs
    (``op.node``: masks, threshold bins, CEGB penalties) against
    ``find_best_split`` by torch on the card under the same inputs: every
    field bit-equal. Returns 0.0."""
    import torch
    from lightgbm_tpu_torch.ops import partition as P
    from lightgbm_tpu_torch.ops.split import find_best_split

    dev = hists.device
    F, B = hists.shape[1], hists.shape[2]
    out = P.split_out(F, B, dev)
    op(hists, pair, hdr, out)
    mask, thr, delta = op.node.rows(2)
    ref = find_best_split(hists, pair[0:6].view(2, 3), meta, mask, hp,
                          parent_output=pair[6:8], leaf_lower=pair[8:10],
                          leaf_upper=pair[10:12], node_depth=hdr[5],
                          rand_threshold=thr, cegb_delta=delta)
    sync(dev)
    got = out.infos()
    for fld in SCAN_FIELDS:
        x = getattr(got, fld)
        y = getattr(ref, fld).to(x.dtype)
        if not torch.equal(x.contiguous().view(torch.uint8),
                           y.contiguous().view(torch.uint8)):
            raise AssertionError("%s: split_scan %s %s vs find_best_split "
                                 "%s" % (name, fld, x.tolist()[:8],
                                         y.tolist()[:8]))
    return 0.0


def check_scan_leaf(name, loop, s):
    """The one-leaf scan of forced slot ``s`` (the split scan kernel, one
    node) against ``scan_leaf_info`` by torch on the card at the loop's
    state before commit ``s``: child 0 of the outputs bit-equal. Returns
    0.0."""
    import torch
    from lightgbm_tpu_torch.ops.commit import forced_info
    from lightgbm_tpu_torch.ops.scan import scan_leaf_info

    st = loop.state
    fl = loop.f_leaf[s]
    loop.forced_out.fout.fill_(7.0)
    loop.forced_leaf_scan(s)
    if loop.pooled:
        hist = st.hist_pool[fl]
    elif s > 0 and fl == loop.f_leaf[s - 1]:
        hist = loop.out.hists[0]
    elif s > 0 and fl == s:
        hist = loop.out.hists[1]
    else:
        hist = st.hist_pool[fl]
    if loop.bundle is not None:
        hist = loop.feature_view(hist[None], st.leaf_sum[fl:fl + 1])[0]
    ref = scan_leaf_info(hist, st.leaf_sum[fl], st.leaf_out[fl],
                         st.leaf_lower[fl], st.leaf_upper[fl], st.depth[fl],
                         loop.f_mask[s], loop.f_thr[s], loop.meta, loop.hp)
    sync(st.hdr.device)
    got = forced_info(loop.forced_out)
    if int(st.force_live[0]) != 1:
        raise AssertionError("%s: forcing stopped before slot %d" % (name,
                                                                     s))
    for fld in SCAN_FIELDS:
        x = getattr(got, fld).reshape(-1)
        y = getattr(ref, fld).reshape(-1).to(x.dtype)
        if not torch.equal(x.view(torch.uint8), y.view(torch.uint8)):
            raise AssertionError("%s: the forced leaf's scan %s %s vs %s"
                                 % (name, fld, x.tolist()[:8],
                                    y.tolist()[:8]))
    return 0.0


#: (name, the forced scan's gain: valid or -inf, every best gain -inf):
#: a forced round, a forced round whose leaf cannot split there (the best
#: split instead, forcing stops) and one where no leaf can split either
#: (nothing is committed)
COMMIT_FORCED_CASES = (("forced_valid", True, False),
                       ("forced_invalid", False, False),
                       ("forced_invalid_dead", False, True))


def phase_commit_options(dev, rng, L=63, F=9, B=40, n_forced=7):
    """The extended split commit against its twin on seeded states
    (COMMIT_FORCED_CASES, slot 3 of 7 forced ones, each leaf's used
    features kept, the model's used set): every table bit-equal. Returns
    {name: 0.0}."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.ops import commit as C
    from lightgbm_tpu_torch.ops import partition as P

    errs = {}
    monotone = torch.as_tensor(rng.randint(-1, 2, F).astype("int8")).to(dev)
    for name, valid, dead in COMMIT_FORCED_CASES:
        st, out = commit_state(dev, rng, L, F, B)
        s = 3
        st.hdr[s - 1, 6] = 1
        st.leaf_used.copy_(torch.as_tensor(rng.rand(L, F) < 0.2))
        st.tree_used.copy_(torch.as_tensor(rng.rand(F) < 0.3))
        st.force_live.fill_(1)
        if dead:
            st.best_gain.fill_(float("-inf"))
            out.fout[0:2].fill_(float("-inf"))
        fo = P.split_out(F, B, dev)
        fo.fout.copy_(torch.as_tensor(rng.randn(18).astype(np.float32)))
        fo.fout[0] = float(abs(rng.randn())) if valid else float("-inf")
        fo.iout.copy_(torch.as_tensor(np.concatenate(
            [rng.randint(F, size=2), rng.randint(B, size=2),
             rng.randint(4, size=2)])))
        fo.bout.copy_(torch.as_tensor(rng.rand(2 + 2 * B) < 0.5))
        kw = dict(max_depth=-1, monotone=monotone, has_monotone=True,
                  forced=fo, n_forced=n_forced, f_leaf=2, track_used=True)
        a = C.TreeState(*(x.clone() for x in st))
        b = C.TreeState(*(x.clone() for x in st))
        C.split_commit(a, out, s, **kw)
        C.split_commit_plain(b, out, s, **kw)
        sync(dev)
        for fld, x, y in zip(C.TreeState._fields, a, b):
            if not torch.equal(x.view(torch.uint8), y.view(torch.uint8)):
                raise AssertionError("commit/%s: %s differs from its twin"
                                     % (name, fld))
        live = int(a.hdr[s, 6])
        want_live = 0 if dead else 1
        if live != want_live or int(a.force_live[0]) != int(valid):
            raise AssertionError("commit/%s: live %d, forcing %d"
                                 % (name, live, int(a.force_live[0])))
        errs["commit/" + name] = 0.0
    return errs


def check_goss_compact_bits(dev, data, rows=GOSS_BITS_ROWS, leaves=63):
    """GOSS compaction on the card against the dense path on gradients
    and hessians drawn in full float32 over magnitudes e^-4 to e^4 (the
    sums round, so the order of the card's f32 additions shows in the
    bits): the compacting device
    loop's tree (the in-bag rows gathered and counted on the card), the
    per-split host loop's compacted tree and the dense device loop's tree
    (every row, in-bag ones first), log field by field. Returns 0.0."""
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lgt

    X, y = data[0][:rows], data[1][:rows]
    rng = np.random.RandomState(53)
    w = np.exp(rng.uniform(-4, 4, rows))
    g = rng.randn(rows) * w
    h = (rng.rand(rows) * 0.25 + 1e-3) * w
    inbag = (rng.rand(rows) < GOSS_BITS_INBAG).astype(np.float64)
    ghc = torch.as_tensor(np.stack([g * inbag, h * inbag, inbag], axis=1)
                          .astype(np.float32)).to(dev)
    logs = {}
    for gc in ("on", "off"):
        params = train_params(dev, leaves, dict(GOSS_PARAMS,
                                                tpu_goss_compact=gc))
        lrn = lgt.Booster(params, lgt.Dataset(X, label=y, params=params)) \
            .inner.learner
        if (gc == "on") != lrn._kw["goss_compact"] \
                or not lrn._kw["inbag_first"]:
            raise AssertionError("goss_compact/bits: compaction %s did not "
                                 "resolve" % gc)
        logs[gc] = lrn.train_device(ghc)
        logs[gc + "_host_loop"] = lrn.train(ghc)
    sync(dev)
    want = logs["off"]
    for tag in ("on", "on_host_loop", "off_host_loop"):
        for fld in want._fields:
            a, b = getattr(logs[tag], fld), getattr(want, fld)
            if not torch.equal(a.view(torch.uint8), b.view(torch.uint8)):
                raise AssertionError("goss_compact/bits: %s %s differs "
                                     "from the dense tree" % (tag, fld))
    if int(want.num_splits[0]) < 2:
        raise AssertionError("goss_compact/bits: %d splits"
                             % int(want.num_splits[0]))
    log("goss_compact/bits: %d rows, %d in bag, the compact tree (%d "
        "splits) bit-equal to the dense one" % (rows, int(inbag.sum()),
                                                int(want.num_splits[0])))
    return 0.0


def options_learner(dev, data, extra, rows, leaves):
    """A booster's learner on the first ``rows`` rows with TRAIN_PARAMS and
    ``extra``, and its gradients' (N, 3) channels at the initial scores."""
    import torch
    import lightgbm_tpu_torch as lgt
    X, y = data[0][:rows], data[1][:rows]
    params = dict(train_params(dev, leaves, extra))
    bst = lgt.Booster(params, lgt.Dataset(X, label=y, params=params))
    g = bst.inner
    grad, hess = g.objective.get_gradients(g.train_score.score)
    return g.learner, torch.stack([grad, hess, torch.ones_like(grad)],
                                  dim=1)


def phase_options_kernels(dev, rng, data, forced_file, rows, leaves):
    """Phase 3h's kernel checks: the node inputs kernel against its twin
    at F = 28 and 137; the split scan with every node input live (by-node
    masks, extra-trees bins, constraint sets, CEGB penalties) against
    find_best_split at the root split and the last live split of a tree on
    ``rows`` rows; the forced leaf's scan at each forced slot; the extended
    commit at COMMIT_FORCED_CASES. Returns (errs, the learner with every
    option, the forced learner, their channels)."""
    errs = {}
    for F, S in ((28, 3), (137, 3), (137, NODE_MANY_SETS)):
        key = "node_inputs/F%d" % F + ("/S%d" % S if S != 3 else "")
        errs[key] = check_node_draws(key, dev, rng, F, S=S)
    errs.update(phase_commit_options(dev, rng))
    errs["goss_compact/bits"] = check_goss_compact_bits(
        dev, data, rows=min(rows, GOSS_BITS_ROWS), leaves=leaves)
    every = dict(OPTIONS_CEGB, feature_fraction_bynode=0.5,
                 extra_trees=True, interaction_constraints=OPTIONS_SETS)
    lrn, ghc = options_learner(dev, data, every, rows, leaves)
    L = lrn.num_leaves
    loop = loop_state_at(lrn, ghc, L - 1)
    live = loop.state.hdr[:, 6].cpu()
    deep = max(s for s in range(L - 1) if int(live[s]) == 1)
    for where, s in (("root", 0), ("deep", deep)):
        loop, hdr, pair, hists, _ = chain_split_at(lrn, ghc, s)
        key = "split_scan/options/%s" % where
        errs[key] = check_split_scan_node(key, loop.split.scan,
                                          hists.clone(), pair, hdr,
                                          lrn.meta, lrn.hp)
        if loop.pooled:
            errs[key + "/fold"] = check_split_fold(
                key + "/fold", *fold_inputs_at(lrn, ghc, s), s)
    flrn, fghc = options_learner(
        dev, data, {"forcedsplits_filename": forced_file}, rows, leaves)
    for s in range(len(OPTIONS_FORCED)):
        loop = loop_state_at(flrn, fghc, s)
        key = "split_scan/forced_leaf/s%d" % s
        errs[key] = check_scan_leaf(key, loop, s)
    return errs, (lrn, ghc), (flrn, fghc)


def time_options_kernels(dev, every, forced, errs):
    """The extended kernels' ms at phase 3h's learners (F = 28, B = 255):
    node_inputs (both children, every option) against its twin by torch
    on the card; the split scan with node inputs at the deep leaf against
    find_best_split; the commit of a forced round against its twin.
    Returns the kernels-line rows (node_inputs) and the extended rows'
    timings (split_scan, split_commit)."""
    from lightgbm_tpu_torch.ops import commit as C
    from lightgbm_tpu_torch.ops import node as N
    from lightgbm_tpu_torch.ops import partition as P
    from lightgbm_tpu_torch.ops.split import find_best_split

    lrn, ghc = every
    L = lrn.num_leaves
    loop = loop_state_at(lrn, ghc, L - 1)
    live = loop.state.hdr[:, 6].cpu()
    deep = max(s for s in range(L - 1) if int(live[s]) == 1)
    loop, hdr, pair, hists, _ = chain_split_at(lrn, ghc, deep)
    st, F, B = loop.state, loop.num_feat, loop.num_bin
    nb = N.node_buf(loop.opts, F, dev)
    kw = dict(opts=loop.opts, fmask=loop.fmask, num_bins=lrn.meta.num_bins,
              coupled=lrn.meta.cegb_coupled, hp=lrn.hp,
              sums=st.pair[deep, 0:6].view(2, 3), used=st.leaf_used,
              tree_used=st.tree_used)
    leaf = st.hdr[deep, 7:8]
    n_ms = cuda_ms(lambda: N.node_inputs(nb, loop.keys, deep, leaf,
                                         deep + 1, 2, **kw))
    n_dev = device_ms(lambda: N.node_inputs(nb, loop.keys, deep, leaf,
                                            deep + 1, 2, **kw))
    n_plain = cuda_ms(lambda: N.node_inputs_plain(
        nb, loop.keys, deep, leaf, deep + 1, 2, **kw), iters=5, warmup=1)
    S = 0 if loop.opts.sets is None else int(loop.opts.sets.shape[0])
    # reads: the keys, the mask, bins, penalties, used row and model set,
    # the sets; writes (2, F) masks, bins and penalties. Operations: two
    # draws of F uniforms a node (~130 integer operations each), the F^2
    # rank compares and the S x F set tests
    n_bytes = 32 + F * (1 + 4 + 4 + 1 + 1) + S * F + 2 * F * (1 + 4 + 4)
    n_ops = 2 * (2 * F * 130 + F * F * 3 + 2 * S * F + 6 * F)
    op = loop.split.scan
    mask, thr, delta = op.node.rows(2)
    s_plain = cuda_ms(lambda: find_best_split(
        hists, pair[0:6].view(2, 3), lrn.meta, mask, lrn.hp,
        parent_output=pair[6:8], leaf_lower=pair[8:10],
        leaf_upper=pair[10:12], node_depth=hdr[5], rand_threshold=thr,
        cegb_delta=delta), iters=5, warmup=1)
    # the scan as the loop launches it (the sibling folded in), with its
    # stamped phases
    _, call = scan_call_at(lrn, ghc, deep)
    s_ms = cuda_ms(call)
    s_dev = device_ms(call)
    log_scan_stamps("phase 3h scan with node inputs (slot %d)" % deep, call,
                    dev)
    flrn, fghc = forced
    floop = loop_state_at(flrn, fghc, 2)
    floop.forced_leaf_scan(2)
    fst = floop.state
    a = C.TreeState(*(x.clone() for x in fst))
    ckw = dict(max_depth=floop.commit.max_depth,
               monotone=flrn.meta.monotone,
               has_monotone=flrn.hp.has_monotone,
               col_map=floop.commit.col_map, forced=floop.forced_out,
               n_forced=floop.n_forced, track_used=False,
               pooled=floop.pooled)
    cop = C.SplitCommit(a, floop.out, **ckw)
    c_ms = cuda_ms(lambda: cop(2, floop.f_leaf[2]))
    c_dev = device_ms(lambda: cop(2, floop.f_leaf[2]))
    b = C.TreeState(*(x.clone() for x in fst))
    c_plain = cuda_ms(lambda: C.split_commit_plain(
        b, floop.out, 2, f_leaf=floop.f_leaf[2], **ckw), iters=5, warmup=1)
    log("phase 3h kernels at F = %d, B = %d: node_inputs %.4f ms (device "
        "%.4f, twin %.3f) at slot %d; split_scan with node inputs %.4f ms "
        "(device %.4f, find_best_split %.3f); forced commit %.4f ms (device "
        "%.4f, twin %.3f)" % (F, B, n_ms, n_dev, n_plain, deep, s_ms, s_dev,
                              s_plain, c_ms, c_dev, c_plain))
    rows = {"node_inputs": dict(
        route="cuda", source="lightgbm_tpu_torch/csrc/node_draws.cu",
        replaces="lightgbm_tpu/learner.py:228 (_make_best_for node_inputs, "
                 "XLA; no pallas_call)",
        max_abs_err=max(v for k, v in errs.items()
                        if k.startswith("node_inputs/")),
        ms=n_ms, device_ms=n_dev, plain_ms=n_plain, library_ms=None,
        bytes=n_bytes, ops=n_ops)}
    # as the loop launches it: the parent's and the smaller child's rows
    # read, both children's written
    scan_bytes = 4 * F * B * 12 + 48 + 2 * (64 + B) + 2 * F * 9
    # the commit copies the two children into the pool only where the scan
    # did not pool them (as full_width_commit counts it)
    c_bytes = ((0 if floop.pooled else 2 * 2 * F * B * 3 * 4) + L * 4
               + 2 * B + 512)
    extended = {
        "split_scan": dict(ms=s_ms, device_ms=s_dev, plain_ms=s_plain,
                           bound_ms=max(scan_bytes / PEAK_BYTES_PER_S,
                                        2 * 4 * F * B * 11
                                        / PEAK_SCALAR_OPS_PER_S) * 1e3),
        "split_commit": dict(ms=c_ms, device_ms=c_dev, plain_ms=c_plain,
                             bound_ms=c_bytes / PEAK_BYTES_PER_S * 1e3)}
    return rows, extended


def options_run(dev, data, name, extra, trees, per_iter, leaves,
                tag="3h"):
    """One configuration of phase 3h (``tag``) at full width: fused
    ``trees`` trees
    (launch counts zeroed just before, read just after), then ``per_iter``
    trees per iteration (a callback) whose model must be the first fused
    trees' byte for byte (``per_iter`` 0: none), then ``trees`` more fused
    trees on the fused booster, whose graphs are captured by then (the
    steady wall a tree). Returns (fused booster, counts, summary)."""
    import hashlib
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import kernels

    X, y = data[0], data[1]
    params = train_params(dev, leaves, extra)
    train = lgt.Dataset(X, label=y, params=params)
    train.construct()
    sync(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    bst = lgt.train(dict(params), train, trees)
    sync(dev)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    g = bst.inner
    if g._fused is None:
        raise AssertionError("phase %s %s: training did not take the fused "
                             "path" % (tag, name))
    text = bst.model_to_string()
    Xv, yv = data[2], data[3]
    s = dict(trees=trees, wall_per_tree_ms=wall / trees * 1e3,
             model_sha256=hashlib.sha256(text.encode()).hexdigest(),
             leaves=[t.num_leaves for t in g.models],
             split_kernel=g.learner._kw["split_kernel"],
             train_logloss=bst.eval_train()[1][2],
             valid_logloss={k: logloss_np(yv, bst.predict(
                 Xv, num_iteration=k)) for k in (min(3, trees), trees)})
    if per_iter:
        t0 = time.perf_counter()
        eager = lgt.train(dict(params), train, per_iter,
                          callbacks=[lambda env: None])
        s["per_iteration_wall_per_tree_ms"] = \
            (time.perf_counter() - t0) / per_iter * 1e3
        if model_text(eager, per_iter) != model_text(bst, per_iter):
            raise AssertionError("phase %s %s: the per-iteration model is "
                                 "not the first fused trees' byte for byte"
                                 % (tag, name))
        s["per_iteration_equal"] = True
    sync(dev)
    t0 = time.perf_counter()
    g.train_block(trees)
    g.finish_fused("steady")
    sync(dev)
    s["steady_wall_per_tree_ms"] = (time.perf_counter() - t0) / trees * 1e3
    log("phase %s %s: %d fused trees in %.1f ms a tree with the first "
        "eager trees and the graph captures, %.1f ms a tree in a second "
        "block (%s), leaves %s, train logloss %.7f, valid logloss %s, "
        "sha256 %s; launches %s"
        % (tag, name, trees, s["wall_per_tree_ms"],
           s["steady_wall_per_tree_ms"], s["split_kernel"], s["leaves"],
           s["train_logloss"],
           s["valid_logloss"], s["model_sha256"], counts))
    return bst, counts, s


def logloss_np(y, p):
    """Binary log loss of probabilities ``p`` for 0/1 labels ``y``."""
    import numpy as np
    p = np.clip(np.asarray(p, np.float64), 1e-15, 1 - 1e-15)
    return float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))


def options_card_vs_host(dev, data, name, extra, rows, trees, leaves,
                         tag="3h"):
    """``extra`` on the first ``rows`` rows on the card and on the host
    (the plain twins): the splits that agree (split_agreement) and the
    train logloss within OPTIONS_METRIC_TOL."""
    import lightgbm_tpu_torch as lgt
    X, y = data[0][:rows], data[1][:rows]
    params = train_params(dev, leaves, extra)
    bst = lgt.train(params, lgt.Dataset(X, label=y, params=params), trees)
    ca, lc = tree_splits(bst), bst.eval_train()[1][2]
    del bst
    out = {}

    def check(host):
        lh = host["eval_train"][1][2]
        agree, total, first = split_agreement(ca, host["splits"])
        log("phase %s card vs host %s: %d rows x %d trees x %d leaves; %d "
            "of %d splits agree (first tree %d of %d); train logloss card "
            "%.9f host %.9f (|diff| %.3g, limit %.1g)"
            % (tag, name, rows, trees, leaves, agree, total, first[0],
               first[1], lc, lh, abs(lc - lh), OPTIONS_METRIC_TOL))
        if not abs(lc - lh) <= OPTIONS_METRIC_TOL:
            raise AssertionError("phase %s %s: train logloss card %.9f host "
                                 "%.9f" % (tag, name, lc, lh))
        out.update(splits_agree=agree, splits=total, logloss_card=lc,
                   logloss_host=lh)

    host_run(params, X, y, trees, check)
    return out


def phase_options(dev, data, card, trees=OPTIONS_TREES,
                  per_iter=OPTIONS_PER_ITER_TREES, leaves=255,
                  host_rows=OPTIONS_HOST_ROWS, host_trees=OPTIONS_HOST_TREES,
                  host_leaves=OPTIONS_HOST_LEAVES, timed=True, seed=0):
    """Phase 3h: the per-node split options and GOSS compaction through the
    device tree loop at full width (phase 3's data, ``leaves`` leaves, 255
    bins), each configuration of options_configs fused (``trees`` trees;
    launch counts zeroed just before and read just after) and, for (a),
    (b) and (d), ``per_iter`` trees per iteration byte-equal to the first
    fused ones. (d)'s trees carry the forced splits at their top three
    levels, through the one-kernel split that ``auto`` picks; (c) on
    against off. The kernel checks of phase_options_kernels (at
    ``host_rows`` rows and ``host_leaves`` leaves), and (a) and (b) card
    against host at ``host_rows`` rows x ``host_trees`` trees x
    ``host_leaves`` leaves. Returns (summary, {config: launch counts},
    errs, the kernels-line rows: node_inputs, and the extended split_scan
    and split_commit timings under "extended")."""
    import shutil
    import tempfile
    import numpy as np

    tmp = tempfile.mkdtemp(prefix="lgbt_forced_")
    try:
        forced_file = forced_json(os.path.join(tmp, "forced.json"))
        rng = np.random.RandomState(seed + 47)
        errs, every, forced = phase_options_kernels(
            dev, rng, data, forced_file, host_rows, host_leaves)
        rows, extended = ({}, {}) if not timed else time_options_kernels(
            dev, every, forced, errs)
        del every, forced
        configs = options_configs(forced_file)
        summary, counts_by = {}, {}
        for name, extra in configs.items():
            bst, counts, s = options_run(dev, data, name, extra, trees,
                                         per_iter, leaves)
            L1 = leaves - 1
            want = {"split_commit": trees * leaves}
            if name in ("bynode_extra", "constraints_cegb_forced"):
                want.update(node_inputs=trees * leaves,
                            split_scan=trees * L1)
            if name == "constraints_cegb_forced":
                want["split_scan"] += trees * len(OPTIONS_FORCED)
            if name == "forced_one_kernel":
                want.update(one_kernel_split=trees * L1,
                            split_scan=trees * len(OPTIONS_FORCED),
                            node_inputs=0)
                if s["split_kernel"] != "on" and dev.type == "cuda":
                    raise AssertionError("phase 3h: auto did not resolve "
                                         "to the one-kernel split")
                feats = [f for f, _ in OPTIONS_FORCED]
                for i, t in enumerate(bst.inner.models):
                    if list(t.split_feature[:len(feats)]) != feats:
                        raise AssertionError(
                            "phase 3h: tree %d's top splits %s, forced %s"
                            % (i, list(t.split_feature[:len(feats)]),
                               feats))
            if name.startswith("goss"):
                want["split_scan"] = trees * L1
            if dev.type == "cuda" and any(counts.get(k, 0) != v
                                          for k, v in want.items()):
                raise AssertionError("phase 3h %s launches %s, want %s"
                                     % (name, counts, want))
            summary[name] = s
            counts_by[name] = counts
            del bst
        on, off = summary["goss_compact_on"], summary["goss_compact_off"]
        on["equal_to_off"] = on["model_sha256"] == off["model_sha256"]
        log("phase 3h GOSS compaction on vs off (%s): byte-equal %s; valid "
            "logloss %s vs %s; train logloss %.9f vs %.9f; %.1f vs %.1f ms "
            "a tree in a second block"
            % (card, on["equal_to_off"], on["valid_logloss"],
               off["valid_logloss"], on["train_logloss"],
               off["train_logloss"], on["steady_wall_per_tree_ms"],
               off["steady_wall_per_tree_ms"]))
        if not on["equal_to_off"]:
            raise AssertionError(
                "phase 3h: the compacted GOSS model (sha256 %s) differs "
                "from the dense one (%s)" % (on["model_sha256"],
                                             off["model_sha256"]))
        for name in ("bynode_extra", "constraints_cegb_forced"):
            summary[name]["card_vs_host"] = options_card_vs_host(
                dev, data, name, configs[name], host_rows, host_trees,
                host_leaves)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if rows:
        rows["node_inputs"]["launches_by_config"] = {
            k: c.get("node_inputs", 0) for k, c in counts_by.items()}
    return summary, counts_by, errs, dict(rows, extended=extended)


# ----------------------------------------------------------- monotone phase

#: phase 3i: the intermediate and advanced monotone methods through the
#: device tree loop and DART and RF per iteration, at full width (phase
#: 3's data, 255 leaves, 255 bins): fused trees of each monotone method,
#: the first per-iteration trees compared with the first fused ones, the
#: per-iteration trees of DART and RF, and the card-vs-host runs (3g's
#: size)
MONO_TREES = 10
#: per-iteration trees of (a), (b) and (f) ((e) runs none: (a) holds the
#: intermediate method's loops to each other), and DART's and RF's, cut
#: from 3 and MONO_TREES to keep 3i near 100 s of the script (~1.0-1.5 s
#: a tree per iteration at full width)
MONO_PER_ITER_TREES = 2
MONO_BOOST_TREES = 5
MONO_HOST_ROWS = 200_000
MONO_HOST_TREES = 3
MONO_HOST_LEAVES = 63
#: the constrained columns of higgs_like and their signs, on columns the
#: label model (higgs_signal) uses: the lepton pT (+), the missing energy
#: (-), jet 1's b-tag (+) and five of the masses, two of them against
#: their sign in the signal (so that the bounds bite)
MONO_COLUMNS = {0: 1, 3: -1, 8: 1, 21: 1, 22: 1, 23: -1, 24: 1, 27: -1}
#: rows of the monotonicity sweep, and the largest step against a
#: column's sign it allows (tests/test_monotone.py's criterion)
MONO_SWEEP_ROWS = 2000
MONO_SWEEP_TOL = 1e-7
DART_PARAMS = {"boosting": "dart", "drop_rate": 0.1, "skip_drop": 0.0}
RF_PARAMS = {"boosting": "rf", "bagging_fraction": 0.7, "bagging_freq": 1,
             "feature_fraction": 0.8}
#: feature counts of the monotone kernels' checks (phase 3's and 3f's)
MONO_CHECK_FEATURES = (28, 137)
#: (e) and (f) of phase 3i: both methods on two columns of phase 3's
#: data, the lepton pT (+) and its eta (free: the label model's -|eta|).
#: On three or more features the JAX package's advanced method bounds
#: every candidate as the intermediate method bounds the leaf (ROADMAP.md
#: C), so (a) and (b) grow equal models; with two its per-bin bounds
#: bite, and (f) differs from (e)
MONO_PAIR_COLUMNS = (0, 1)
MONO_PAIR_SIGNS = {0: 1}


def mono_constraints(num_feat=HIGGS_FEATURES):
    return [MONO_COLUMNS.get(f, 0) for f in range(num_feat)]


def monotone_configs():
    """The configurations of phase 3i: (a) intermediate and (b) advanced
    monotone constraints on MONO_COLUMNS, (c) DART dropping at every
    iteration, (d) RF with bagging and column sampling."""
    c = mono_constraints()
    return {
        "intermediate": {"monotone_constraints": c,
                         "monotone_constraints_method": "intermediate"},
        "advanced": {"monotone_constraints": c,
                     "monotone_constraints_method": "advanced"},
        "dart": dict(DART_PARAMS),
        "rf": dict(RF_PARAMS),
    }


def monotone_pair(data):
    """Phase 3i's (e) and (f): (data cut to MONO_PAIR_COLUMNS, {name:
    params}) for the intermediate and advanced methods."""
    import numpy as np
    X, y, Xv, yv = data
    cols = list(MONO_PAIR_COLUMNS)
    c = [MONO_PAIR_SIGNS.get(f, 0) for f in range(len(cols))]
    return ((np.ascontiguousarray(X[:, cols]), y,
             np.ascontiguousarray(Xv[:, cols]), yv),
            {m + "_pair": {"monotone_constraints": c,
                           "monotone_constraints_method": m}
             for m in ("intermediate", "advanced")})


def mono_state(dev, rng, L, F, B):
    """A seeded advanced state on ``dev``: each leaf's box inside a
    feature's bins, bounds on a 1/8 grid (ties) with a third unbounded,
    and (F,) i8 constraints of mixed signs. Returns (cons_lo, cons_hi,
    rng_lo, rng_hi, monotone, num_bins)."""
    import numpy as np
    import torch
    nb = rng.randint(max(2, B // 2), B + 1, F).astype(np.int32)
    lo = rng.randint(0, nb - 1, size=(L, F))
    hi = lo + 1 + (rng.rand(L, F) * (nb - 1 - lo)).astype(np.int64)
    cons_lo = rng.randint(-12, 4, size=(L, F, B)) / 8.0
    cons_hi = rng.randint(-4, 12, size=(L, F, B)) / 8.0
    cons_lo[rng.rand(L, F, B) < 0.3] = -np.inf
    cons_hi[rng.rand(L, F, B) < 0.3] = np.inf
    mono = rng.randint(-1, 2, F).astype(np.int8)

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dtype).to(dev)

    return (t(cons_lo, torch.float32), t(cons_hi, torch.float32),
            t(lo, torch.int32), t(hi, torch.int32), t(mono, torch.int8),
            nb)


def same_bytes(name, got, want):
    """Every tensor pair bit-equal (compared as bytes: NaN and -0.0
    count). Returns 0.0."""
    import torch
    for i, (x, y) in enumerate(zip(got, want)):
        if not torch.equal(x.contiguous().view(torch.uint8),
                           y.contiguous().view(torch.uint8)):
            bad = x.contiguous().view(torch.uint8) \
                != y.contiguous().view(torch.uint8)
            raise AssertionError("%s: output %s differs from its twin (%d of "
                                 "%d bytes)" % (name, i,
                                                int(torch.count_nonzero(bad)),
                                                bad.numel()))
    return 0.0


def same_fields(name, fields, got, want):
    """same_bytes with each pair named by its field. Returns 0.0."""
    for fld, x, y in zip(fields, got, want):
        same_bytes("%s %s" % (name, fld), [x], [y])
    return 0.0


def check_mono_kernels(dev, rng, F, L=63, B=255):
    """mono_bounds and mono_commit (the kernels on card tensors) against
    their twins run by torch on the same card tensors, bit-equal, at
    three states: a numerical winner (the children's boxes cut on the
    split feature), a categorical winner (the children's boxes the
    parent's) and an invalid round (live 0: nothing written). Keys name
    F, and L where it is not 63. Returns {name: 0.0}."""
    import torch
    from lightgbm_tpu_torch.ops import monotone as M

    errs = {}
    i32 = torch.int32
    shape = "F%d" % F if L == 63 else "F%d_L%d" % (F, L)
    for case in ("numerical", "categorical", "invalid"):
        cons_lo, cons_hi, rlo, rhi, mono, nb = mono_state(dev, rng, L, F, B)
        leaf, new = int(rng.randint(0, L // 2)), L // 2 + 1
        f = int(rng.randint(F))
        t = int(rng.randint(max(1, nb[f] - 1)))
        # the commit's box cut: the new leaf's row is the parent's
        rlo[new] = rlo[leaf]
        rhi[new] = rhi[leaf]
        if case == "numerical":
            rhi[leaf, f] = t + 1
            rlo[new, f] = t + 1
        live = 0 if case == "invalid" else 1
        word = torch.full((1,), leaf, dtype=i32, device=dev)
        live_w = torch.full((1,), live, dtype=i32, device=dev)
        outs = [torch.full((2, 4, F, B), 7.0, device=dev) for _ in range(2)]
        state = (cons_lo, cons_hi, rlo, rhi)
        M.mono_bounds(*state, word, new, 2, outs[0], live=live_w)
        M.mono_bounds_plain(*state, word, new, 2, outs[1], live=live_w)
        sync(dev)
        key = "mono_bounds/%s/%s" % (shape, case)
        errs[key] = same_bytes(key, outs[:1], outs[1:])
        # one forced leaf, node 0 only
        M.mono_bounds(*state, word, 0, 1, outs[0])
        M.mono_bounds_plain(*state, word, 0, 1, outs[1])
        sync(dev)
        key = "mono_bounds/%s/%s/one_leaf" % (shape, case)
        errs[key] = same_bytes(key, outs[:1], outs[1:])
        words = torch.tensor([live, leaf], dtype=i32).to(dev)
        vals = torch.as_tensor(rng.randint(-16, 16, 2) / 8.0).to(
            torch.float32).to(dev)
        a = [x.clone() for x in state]
        b = [x.clone() for x in state]
        M.mono_commit(*a, mono, words, vals, new)
        M.mono_commit_plain(*b, mono, words, vals, new)
        sync(dev)
        key = "mono_commit/%s/%s" % (shape, case)
        errs[key] = same_bytes(key, a, b)
        if case == "invalid":
            errs[key] = same_bytes(key + "/unchanged", a, state)
    return errs


#: (name, slot as a fraction of L - 1, live word of slot s - 1, state
#: options) of the extended commit's checks under each monotone method
COMMIT_MONO_CASES = (("first", 0, 1, {}), ("mid", 0.5, 1, {}),
                     ("ties", 0.5, 1, {"ties": True}),
                     ("after_stop", 0.5, 0, {}), ("final", 1.0, 1, {}))


def check_commit_mono(dev, rng, L=63, F=9, B=40, suffix=""):
    """The extended split commit against its twin under the intermediate
    (1) and advanced (2) methods on seeded states (COMMIT_MONO_CASES, the
    state of mono_state: boxes, per-bin bounds, scalar bounds), and a
    forced round whose leaf cannot split there: every table bit-equal.
    Returns {name + ``suffix``: 0.0}."""
    import torch
    from lightgbm_tpu_torch.ops import commit as C
    from lightgbm_tpu_torch.ops import partition as P

    errs = {}
    for method in (1, 2):
        cases = COMMIT_MONO_CASES + (("forced_invalid", 3, 1, {}),)
        for name, where, live, opts in cases:
            st, out = commit_state(dev, rng, L, F, B, **opts)
            cons_lo, cons_hi, rlo, rhi, mono, nb = mono_state(dev, rng, L, F,
                                                              B)
            st = st._replace(rng_lo=rlo, rng_hi=rhi,
                             cons_lo=cons_lo if method == 2 else st.cons_lo,
                             cons_hi=cons_hi if method == 2 else st.cons_hi)
            # best bins inside the features' bins
            st.best_bin.copy_(torch.as_tensor(
                rng.randint(0, 10 ** 6, L) % (nb[st.best_feature.cpu()
                                                    .numpy()] - 1)).to(dev))
            s = where if isinstance(where, int) \
                else int(round(where * (L - 1)))
            if s > 0:
                st.hdr[s - 1, 6] = live
            kw = dict(max_depth=-1, monotone=mono, has_monotone=True,
                      mono_method=method)
            if name == "forced_invalid":
                fo = P.split_out(F, B, dev)
                fo.fout.fill_(float("-inf"))
                st.force_live.fill_(1)
                kw.update(forced=fo, n_forced=7, f_leaf=2)
            a = C.TreeState(*(x.clone() for x in st))
            b = C.TreeState(*(x.clone() for x in st))
            C.split_commit(a, out, s, **kw)
            C.split_commit_plain(b, out, s, **kw)
            sync(dev)
            key = "commit/mono%d/%s%s" % (method, name, suffix)
            errs[key] = same_fields(key, C.TreeState._fields, a, b)
    return errs


def check_split_scan_adv(name, loop, s):
    """The split scan kernel under the advanced method (each candidate's
    child bounds from the loop's bounds buffer: the children of slot
    ``s``, the last slot the loop ran) against find_best_split with
    adv_bounds by torch on the card: every field bit-equal. Returns (0.0,
    the share of finite bounds)."""
    import torch
    from lightgbm_tpu_torch.ops import partition as P
    from lightgbm_tpu_torch.ops.split import find_best_split

    st = loop.state
    hdr, pair = st.hdr[s], st.pair[s]
    hists = loop.children(s)
    F, B = hists.shape[1], hists.shape[2]
    dev = hists.device
    out = P.split_out(F, B, dev)
    loop.split.scan(hists, pair, hdr, out)
    ref = find_best_split(hists, pair[0:6].view(2, 3), loop.meta, loop.fmask,
                          loop.hp, parent_output=pair[6:8],
                          leaf_lower=pair[8:10], leaf_upper=pair[10:12],
                          node_depth=hdr[5],
                          adv_bounds=tuple(loop.bounds.unbind(1)))
    sync(dev)
    got = out.infos()
    same_fields(name + ": split_scan vs find_best_split", SCAN_FIELDS,
                [getattr(got, f) for f in SCAN_FIELDS],
                [getattr(ref, f).to(getattr(got, f).dtype)
                 for f in SCAN_FIELDS])
    return 0.0, float(torch.isfinite(loop.bounds).float().mean())


def phase_monotone_kernels(dev, rng, data, rows, leaves, full_leaves=255):
    """Phase 3i's kernel checks: mono_bounds and mono_commit against their
    twins at F = 28 and 137 (check_mono_kernels, L = 63) and at F = 28, L
    = ``full_leaves``; the extended commit under both methods
    (check_commit_mono) at L = 63 and at F = 28, B = 255, L =
    ``full_leaves``; and the extended split scan against find_best_split
    with adv_bounds at the root split's children and at the last live
    split of a tree on ``rows`` rows under the advanced method. Returns
    errs."""
    errs = {}
    for F in MONO_CHECK_FEATURES:
        errs.update(check_mono_kernels(dev, rng, F))
    errs.update(check_mono_kernels(dev, rng, HIGGS_FEATURES, L=full_leaves))
    errs.update(check_commit_mono(dev, rng))
    errs.update(check_commit_mono(dev, rng, L=full_leaves, F=HIGGS_FEATURES,
                                  B=255, suffix="/full_width"))
    lrn, ghc = options_learner(dev, data, monotone_configs()["advanced"],
                               rows, leaves)
    deep = last_live_slot(lrn, ghc)
    for where, s in (("root", 0), ("deep", deep)):
        loop = loop_state_at(lrn, ghc, s + 1)
        key = "split_scan/advanced/%s" % where
        errs[key], finite = check_split_scan_adv(key, loop, s)
        if loop.pooled:
            errs[key + "/fold"] = check_split_fold(
                key + "/fold", *fold_inputs_at(lrn, ghc, s), s)
        log("phase 3i %s: slot %d, finite bound share %.4f" % (key, s,
                                                               finite))
        if where == "deep" and not finite > 0:
            raise AssertionError("phase 3i: no bound bites at the deep "
                                 "leaf")
    return errs


def last_live_slot(lrn, ghc):
    """The last split slot of a tree on ``ghc`` that split a leaf."""
    loop = loop_state_at(lrn, ghc, lrn.num_leaves - 1)
    live = loop.state.hdr[:, 6].cpu()
    return max(s for s in range(lrn.num_leaves - 1) if int(live[s]) == 1)


def mono_commit_touched(state, mono, words, outs, new_leaf):
    """The (l, f, b) elements of cons_lo and cons_hi that mono_commit's
    gates select at this state (either child; the new leaf's inherited
    rows aside): the twin run on copies with NaN outputs, which min and
    max carry into every selected element."""
    import torch
    from lightgbm_tpu_torch.ops import monotone as M

    cl = [x.clone() for x in state]
    nan = torch.full_like(outs, float("nan"))
    M.mono_commit_plain(*cl, mono, words, nan, new_leaf)
    keep = torch.ones(cl[0].shape[0], dtype=torch.bool, device=nan.device)
    keep[new_leaf] = False
    return sum(int(torch.isnan(x[keep]).sum()) for x in cl[:2])


def full_width_mono_checks(lrn, ghc, method, errs, tag="full_width"):
    """The extended commit (``method`` 1 or 2) and, under the advanced
    method, mono_commit after it, mono_bounds of both children and the
    split scan with their bounds, each kernel and its twin on separate
    copies of the state of a tree on ``ghc`` at the middle slot and the
    last live one (a full-width learner of phase 3i: L = 255, F = 28, or
    F = 2 for the pair): bit-equal, under keys ``*/<tag>_*``. Returns the
    last live slot."""
    import torch
    from lightgbm_tpu_torch.ops import commit as C
    from lightgbm_tpu_torch.ops import monotone as M

    L = lrn.num_leaves
    deep = last_live_slot(lrn, ghc)
    mono = lrn.meta.monotone
    for where, s in (("mid", L // 2), ("deep", deep)):
        loop = loop_state_at(lrn, ghc, s)
        st, dev = loop.state, loop.state.hdr.device
        kw = dict(max_depth=loop.commit.max_depth, monotone=mono,
                  has_monotone=True, mono_method=method)
        a = C.TreeState(*(x.clone() for x in st))
        b = C.TreeState(*(x.clone() for x in st))
        C.split_commit(a, loop.out, s, **kw)
        C.split_commit_plain(b, loop.out, s, **kw)
        sync(dev)
        key = "commit/mono%d/%s_%s" % (method, tag, where)
        errs[key] = same_fields(key, C.TreeState._fields, a, b)
        if method != 2:
            continue
        words, outs = a.hdr[s, 6:8], a.pair[s, 6:8]
        ka = [x.clone() for x in (a.cons_lo, a.cons_hi, a.rng_lo, a.rng_hi)]
        kb = [x.clone() for x in ka]
        M.mono_commit(*ka, mono, words, outs, s + 1)
        M.mono_commit_plain(*kb, mono, words, outs, s + 1)
        sync(dev)
        key = "mono_commit/%s_%s" % (tag, where)
        errs[key] = same_bytes(key, ka, kb)
        F, B = ka[0].shape[1], ka[0].shape[2]
        bo = [torch.full((2, 4, F, B), 7.0, device=dev) for _ in range(2)]
        M.mono_bounds(*ka, a.hdr[s, 7:8], s + 1, 2, bo[0])
        M.mono_bounds_plain(*ka, a.hdr[s, 7:8], s + 1, 2, bo[1])
        sync(dev)
        key = "mono_bounds/%s_%s" % (tag, where)
        errs[key] = same_bytes(key, bo[:1], bo[1:])
        key = "split_scan/advanced/%s_%s" % (tag, where)
        errs[key], _ = check_split_scan_adv(key, loop_state_at(lrn, ghc,
                                                               s + 1), s)
        log("phase 3i %s, L = %d, F = %d, slot %d: commit, mono_commit (%d "
            "elements selected), mono_bounds (finite share %.4f) and the "
            "scan with bounds bit-equal to their twins"
            % (tag, L, F, s, mono_commit_touched(
                (a.cons_lo, a.cons_hi, a.rng_lo, a.rng_hi), mono, words,
                outs, s + 1), float(torch.isfinite(bo[0]).float().mean())))
    return deep


def time_monotone_kernels(dev, adv, errs):
    """The monotone kernels' ms at phase 3i's full-width advanced learner
    (L = 255, F = 28, B = 255) on the fused model's gradients, at the
    last live slot of a tree, after full_width_mono_checks under the
    advanced method: mono_bounds (both children) and mono_commit against
    their twins by torch on the card, the extended split scan against
    find_best_split with adv_bounds, the extended commit against its
    twin. Returns the kernels-line rows (mono_bounds, mono_commit) and the
    extended rows' timings."""
    import torch
    from lightgbm_tpu_torch.ops import commit as C
    from lightgbm_tpu_torch.ops import monotone as M
    from lightgbm_tpu_torch.ops import partition as P
    from lightgbm_tpu_torch.ops.split import find_best_split

    lrn, ghc = adv
    L = lrn.num_leaves
    deep = full_width_mono_checks(lrn, ghc, 2, errs)
    loop = loop_state_at(lrn, ghc, deep)
    st, F, B = loop.state, loop.num_feat, loop.num_bin
    # the commit of slot `deep`, timed on a copy of the state
    a = C.TreeState(*(x.clone() for x in st))
    b = C.TreeState(*(x.clone() for x in st))
    ckw = dict(max_depth=loop.commit.max_depth, monotone=lrn.meta.monotone,
               has_monotone=True, mono_method=2, pooled=loop.pooled)
    cop = C.SplitCommit(a, loop.out, **ckw)
    c_ms = cuda_ms(lambda: cop(deep))
    c_dev = device_ms(lambda: cop(deep))
    c_plain = cuda_ms(lambda: C.split_commit_plain(b, loop.out, deep, **ckw),
                      iters=5, warmup=1)
    loop.commit(deep)
    state = (st.cons_lo, st.cons_hi, st.rng_lo, st.rng_hi)
    words, outs = st.hdr[deep, 6:8], st.pair[deep, 6:8]
    mono = lrn.meta.monotone
    touched = mono_commit_touched(state, mono, words, outs, deep + 1)
    cl = [x.clone() for x in state]
    m_ms = cuda_ms(lambda: M.mono_commit(*cl, mono, words, outs, deep + 1))
    m_dev = device_ms(lambda: M.mono_commit(*cl, mono, words, outs,
                                            deep + 1))
    m_plain = cuda_ms(lambda: M.mono_commit_plain(*cl, mono, words, outs,
                                                  deep + 1),
                      iters=5, warmup=1)
    M.mono_commit(*state, mono, words, outs, deep + 1)
    leaf_w = st.hdr[deep, 7:8]
    bout = torch.empty_like(loop.bounds)
    b_ms = cuda_ms(lambda: M.mono_bounds(*state, leaf_w, deep + 1, 2, bout))
    b_dev = device_ms(lambda: M.mono_bounds(*state, leaf_w, deep + 1, 2,
                                            bout))
    b_plain = cuda_ms(lambda: M.mono_bounds_plain(*state, leaf_w, deep + 1,
                                                  2, bout),
                      iters=5, warmup=1)
    loop = loop_state_at(lrn, ghc, deep + 1)
    st = loop.state
    hdr, pair = st.hdr[deep], st.pair[deep]
    hists = loop.children(deep)
    adv_b = tuple(loop.bounds.unbind(1))
    s_plain = cuda_ms(lambda: find_best_split(
        hists, pair[0:6].view(2, 3), lrn.meta, loop.fmask, lrn.hp,
        parent_output=pair[6:8], leaf_lower=pair[8:10],
        leaf_upper=pair[10:12], node_depth=hdr[5], adv_bounds=adv_b),
        iters=5, warmup=1)
    # the scan as the loop launches it (the sibling folded in)
    _, call = scan_call_at(lrn, ghc, deep)
    s_ms = cuda_ms(call)
    s_dev = device_ms(call)
    log("phase 3i kernels at L = %d, F = %d, B = %d, slot %d: mono_bounds "
        "%.4f ms (device %.4f, twin %.3f); mono_commit %.4f ms (device "
        "%.4f, twin %.3f; %d of %d bound elements selected); split_scan "
        "with bounds %.4f ms (device %.4f, find_best_split %.3f); advanced "
        "commit %.4f ms (device %.4f, twin %.3f)"
        % (L, F, B, deep, b_ms, b_dev, b_plain, m_ms, m_dev, m_plain,
           touched, 2 * L * F * B, s_ms, s_dev, s_plain, c_ms, c_dev,
           c_plain))
    # mono_bounds reads two leaves' (F, B) rows and boxes and writes (2, 4,
    # F, B); per element a row extremum, four scan steps and four outputs
    b_bytes = 2 * (2 * F * B * 4 + 2 * F * 4) + 2 * 4 * F * B * 4
    b_ops = 2 * F * B * 10
    # mono_commit needs the (L, F) boxes, the new leaf's inherited rows
    # (read and written) and a read and a write of each bound element its
    # gates select at this state (mono_commit_touched); per selected
    # element a min or max, per (l, f) the two children's ~24 box tests
    m_bytes = 2 * L * F * 4 + 2 * F * B * 8 + touched * 8
    m_ops = touched + 2 * L * F * 24
    rows = {
        "mono_bounds": dict(
            route="cuda", source="lightgbm_tpu_torch/csrc/monotone.cu",
            replaces="lightgbm_tpu/learner.py:508 (_adv_bounds_of, XLA; no "
                     "pallas_call)",
            max_abs_err=max(v for k, v in errs.items()
                            if k.startswith("mono_bounds/")),
            ms=b_ms, device_ms=b_dev, plain_ms=b_plain, library_ms=None,
            bytes=b_bytes, ops=b_ops),
        "mono_commit": dict(
            route="cuda", source="lightgbm_tpu_torch/csrc/monotone.cu",
            replaces="lightgbm_tpu/learner.py:573 (_adv_commit, XLA; no "
                     "pallas_call)",
            max_abs_err=max(v for k, v in errs.items()
                            if k.startswith("mono_commit/")),
            ms=m_ms, device_ms=m_dev, plain_ms=m_plain, library_ms=None,
            selected_elements=touched, bytes=m_bytes, ops=m_ops)}
    scan_bytes = 4 * F * B * 12 + 2 * 4 * F * B * 4 + 48 + 2 * (64 + B)
    # the commit reads the bound rows; it copies the two children into the
    # pool only where the scan did not pool them
    c_bytes = ((0 if loop.pooled else 2 * 2 * F * B * 3 * 4) + L * 4
               + 2 * B + 512 + 2 * F * B * 4)
    extended = {
        "split_scan": dict(ms=s_ms, device_ms=s_dev, plain_ms=s_plain,
                           bound_ms=max(scan_bytes / PEAK_BYTES_PER_S,
                                        2 * 4 * F * B * 13
                                        / PEAK_SCALAR_OPS_PER_S) * 1e3),
        "split_commit": dict(ms=c_ms, device_ms=c_dev, plain_ms=c_plain,
                             bound_ms=c_bytes / PEAK_BYTES_PER_S * 1e3)}
    return rows, extended


def mono_sweep(bst, X, rng, columns, rows=MONO_SWEEP_ROWS):
    """For each constrained column ({column: sign} ``columns``), every
    bin's value (its upper bound; the last bin past the last bound) put
    in turn into ``rows`` sampled rows of ``X`` (all of them when it has
    fewer), their raw scores predicted through the forest kernel: no step
    along the bins may go against the column's sign by more than
    MONO_SWEEP_TOL. Returns (sweeps, the worst step against a sign)."""
    import numpy as np
    g = bst.inner
    ds = g.train_set
    rows = min(rows, len(X))
    base = X[rng.choice(len(X), size=rows, replace=False)]
    worst, sweeps = 0.0, 0
    for col, sign in columns.items():
        m = ds.bin_mappers[ds.inner_feature_index(col)]
        ub = np.asarray(m.upper_bounds, np.float64)
        vals = np.concatenate([ub[:-1], [ub[-2] + 1.0 if len(ub) > 1
                                         else 1.0]])
        pts = np.repeat(base, len(vals), axis=0)
        pts[:, col] = np.tile(vals, rows)
        p = bst.predict(pts, raw_score=True).reshape(rows, len(vals))
        step = float((np.diff(p, axis=1) * sign).min())
        worst = min(worst, step)
        sweeps += rows
        if step < -MONO_SWEEP_TOL:
            raise AssertionError("phase 3i: column %d (sign %+d) steps %.3g "
                                 "against its sign" % (col, sign, step))
    return sweeps, worst


def boost_run(dev, data, name, extra, trees, leaves):
    """DART or RF at full width, per iteration with phase 3's valid set
    (launch counts zeroed just before, read just after). Returns (booster,
    counts, summary)."""
    import hashlib
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import kernels

    X, y, Xv, yv = data
    params = train_params(dev, leaves, extra)
    train = lgt.Dataset(X, label=y, params=params)
    train.construct()
    valid = lgt.Dataset(Xv, label=yv, reference=train)
    valid.construct()
    sync(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    bst = lgt.train(dict(params), train, trees, valid_sets=[valid])
    sync(dev)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    g = bst.inner
    if g.name != extra["boosting"] or getattr(g, "_fused", None) is not None:
        raise AssertionError("phase 3i %s: trained %s, fused %s"
                             % (name, g.name, g._fused is not None))
    text = bst.model_to_string()
    auc = auc_np(yv, bst.predict(Xv))
    valid_auc = [v for _, m, v, _ in g.eval_valid() if m == "auc"][0]
    if abs(auc - valid_auc) > 1e-5:
        raise AssertionError("phase 3i %s: predicted valid auc %.7f, the "
                             "valid scores' %.7f" % (name, auc, valid_auc))
    s = dict(trees=trees, wall_per_tree_ms=wall / trees * 1e3,
             model_sha256=hashlib.sha256(text.encode()).hexdigest(),
             leaves=[t.num_leaves for t in g.models], valid_auc=auc,
             train_logloss=bst.eval_train()[1][2])
    log("phase 3i %s: %d trees per iteration in %.1f ms a tree, leaves %s, "
        "valid auc %.5f, train logloss %.7f, sha256 %s; launches %s"
        % (name, trees, s["wall_per_tree_ms"], s["leaves"], auc,
           s["train_logloss"], s["model_sha256"], counts))
    return bst, counts, s


def phase_monotone(dev, data, card, trees=MONO_TREES,
                   per_iter=MONO_PER_ITER_TREES, boost_trees=MONO_BOOST_TREES,
                   leaves=255,
                   host_rows=MONO_HOST_ROWS, host_trees=MONO_HOST_TREES,
                   host_leaves=MONO_HOST_LEAVES, timed=True, seed=0):
    """Phase 3i: the intermediate and advanced monotone methods through
    the device tree loop at full width (phase 3's data, ``leaves``
    leaves, 255 bins), (a) and (b) on MONO_COLUMNS, (e) and (f) on the
    two MONO_PAIR_COLUMNS: each fused (``trees`` trees; launch counts
    zeroed just before and read just after), ``per_iter`` trees per
    iteration byte-equal to the first fused ones (none for (e)), a
    second fused block
    timed, and the monotonicity sweep through the forest kernel; (b)
    equal to (a), (f) not equal to (e). DART and RF, ``boost_trees``
    trees each per iteration with the valid set (valid AUC). The kernel
    checks of phase_monotone_kernels (at ``host_rows`` rows and
    ``host_leaves`` leaves) and of full_width_mono_checks on the fused
    learners, and (a)-(d) and (f) card against host at ``host_rows`` rows
    x ``host_trees`` trees x ``host_leaves`` leaves. Returns (summary,
    {config: launch counts}, errs, the kernels-line rows: mono_bounds and
    mono_commit, and the extended split_scan and split_commit timings
    under "extended")."""
    import numpy as np
    import torch

    t_start = time.perf_counter()
    rng = np.random.RandomState(seed + 53)
    errs = phase_monotone_kernels(dev, rng, data, host_rows, host_leaves,
                                  full_leaves=leaves)
    rows, extended = {}, {}
    configs = monotone_configs()
    pair, pair_configs = monotone_pair(data)
    runs = [(n, configs[n], data, MONO_COLUMNS)
            for n in ("intermediate", "advanced")] \
        + [(n, c, pair, MONO_PAIR_SIGNS) for n, c in pair_configs.items()]
    summary, counts_by = {}, {}
    L1 = leaves - 1
    for name, extra, d, columns in runs:
        bst, counts, s = options_run(
            dev, d, name, extra, trees,
            0 if name == "intermediate_pair" else per_iter, leaves,
            tag="3i")
        method = extra["monotone_constraints_method"]
        want = {"split_commit": trees * leaves, "split_scan": trees * L1}
        if method == "advanced":
            want.update(mono_commit=trees * L1, mono_bounds=trees * leaves)
        else:
            want.update(mono_commit=0, mono_bounds=0)
        if dev.type == "cuda" and any(counts.get(k, 0) != v
                                      for k, v in want.items()):
            raise AssertionError("phase 3i %s launches %s, want %s"
                                 % (name, counts, want))
        if dev.type == "cuda" and s["split_kernel"] != "off":
            raise AssertionError("phase 3i %s: not the chain" % name)
        t0 = time.perf_counter()
        s["sweeps"], s["worst_step"] = mono_sweep(
            bst, d[2], np.random.RandomState(seed + 59), columns)
        s["sweep_s"] = time.perf_counter() - t0
        log("phase 3i %s monotonicity: %d sweeps of %d columns, worst step "
            "against a sign %.3g (limit %.0e), %.1f s"
            % (name, s["sweeps"], len(columns), s["worst_step"],
               MONO_SWEEP_TOL, s["sweep_s"]))
        summary[name] = s
        counts_by[name] = counts
        # the kernels against their twins on the fused model's learner
        # (full width), and timed there under the advanced method
        g = bst.inner
        grad, hess = g.objective.get_gradients(g.train_score.score)
        ghc = torch.stack([grad, hess, torch.ones_like(grad)], dim=1)
        code = 2 if method == "advanced" else 1
        if timed and name == "advanced":
            rows, extended = time_monotone_kernels(dev, (g.learner, ghc),
                                                   errs)
        else:
            full_width_mono_checks(g.learner, ghc, code, errs,
                                   tag="pair" if d is pair
                                   else "full_width")
        del bst, g, grad, hess, ghc
    for a, b, equal in (("intermediate", "advanced", True),
                        ("intermediate_pair", "advanced_pair", False)):
        same = summary[a]["model_sha256"] == summary[b]["model_sha256"]
        summary[b]["equal_to_intermediate"] = same
        log("phase 3i %s vs %s: byte-equal models %s" % (b, a, same))
        if same != equal:
            raise AssertionError(
                "phase 3i: %s %s %s (on %d features the JAX package's "
                "methods grow %s models)"
                % (b, "equals" if same else "differs from", a,
                   len(configs["advanced"]["monotone_constraints"])
                   if a == "intermediate" else len(MONO_PAIR_COLUMNS),
                   "equal" if equal else "different"))
    for name in ("dart", "rf"):
        _, counts, s = boost_run(dev, data, name, configs[name],
                                 boost_trees, leaves)
        if dev.type == "cuda" and counts.get("route_rows", 0) <= 0:
            raise AssertionError("phase 3i %s never launched the router"
                                 % name)
        summary[name] = s
        counts_by[name] = counts
    for name, extra, d in [(n, c, data) for n, c in configs.items()] \
            + [("advanced_pair", pair_configs["advanced_pair"], pair)]:
        summary[name]["card_vs_host"] = options_card_vs_host(
            dev, d, name, extra, host_rows, host_trees, host_leaves,
            tag="3i")
    if rows:
        for k in ("mono_bounds", "mono_commit"):
            rows[k]["launches_by_config"] = {
                c: n.get(k, 0) for c, n in counts_by.items()}
    log("phase 3i took %.1f s (%s)" % (time.perf_counter() - t_start, card))
    return summary, counts_by, errs, dict(rows, extended=extended)


# ------------------------------------------- linear trees and the dense builder

#: phase 3j: phase 3's data (2M x 28, 255 leaves, a 100k-row valid set).
#: (a) linear trees per iteration with the valid set, at the default
#: linear_lambda and at LINEAR_LAMBDA; (b) the dense builder past 256 bins
#: (max_bin 1023: u16 bins) and asked for at 255 bins, fused through the
#: device tree loop and per iteration with the valid set. Cut from the
#: reference's 100 trees to these counts to keep the phase near a minute
#: and a half; rows, width, leaves and bins stay full.
LINEAR_TREES = 4
LINEAR_LAMBDA = 1.0
#: the linear fit at a small size, card (the Gram kernel) against host
#: (its twin, linear_device=on): train logloss within LINEAR_METRIC_TOL
#: (the Gram sums add in another order, so the f32 fits differ in their
#: last bits)
LINEAR_HOST_ROWS = 50_000
LINEAR_HOST_TREES = 3
LINEAR_HOST_LEAVES = 63
LINEAR_METRIC_TOL = 1e-5
#: the kernel's fit on the twin's system: relative residual ||A b + B|| /
#: (||A|| ||b|| + ||B||), a few f32 ulps times the sums' relative error
GRAM_RESIDUAL_TOL = 1e-4
DENSE_TREES = 4
DENSE_PER_ITER_TREES = 2
DENSE_CONFIGS = {"u16_1023": {"max_bin": 1023},
                 "dense_255": {"tree_builder": "dense"}}


def gram_inputs(dev, rng, n, F, L, km):
    """Seeded inputs of the Gram kernel: raw features on a 1/1024 grid with
    ~5% NaN, row leaves with some leaves empty or under-determined, g and h
    with out-of-bag zeros, per-leaf feature tables (leaf 0 without
    features, the others 1 to km)."""
    import numpy as np
    import torch
    X = np.round(rng.randn(n, F) * 512) / 1024
    X[rng.rand(n, F) < 0.05] = np.nan
    row_leaf = rng.randint(0, L, n)
    row_leaf[rng.rand(n) < 0.3] = 1                     # a big leaf
    row_leaf[row_leaf == L - 1] = L - 2                 # an empty leaf
    row_leaf[:3] = L - 3                                # a leaf of 3 rows
    g = rng.randn(n)
    h = np.abs(rng.randn(n)) + 0.05
    oob = rng.rand(n) < 0.2
    g[oob], h[oob] = 0.0, 0.0
    ghc = np.stack([g, h, (~oob).astype(float)], axis=1)
    feat_idx = np.zeros((L, km), np.int32)
    feat_mask = np.zeros((L, km), bool)
    for l in range(1, L):
        k = rng.randint(1, km + 1)
        feat_idx[l, :k] = np.sort(rng.choice(F, k, replace=False))
        feat_mask[l, :k] = True

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dtype).to(dev)

    return (t(X, torch.float32), t(row_leaf, torch.int32),
            t(ghc, torch.float32), t(feat_idx, torch.int32),
            t(feat_mask, torch.bool))


def check_linear_gram(name, X, row_leaf, ghc, feat_idx, feat_mask, lam):
    """The Gram kernel (a CUDA tensor) against its twin on the same inputs:
    counts equal; A and B within ``linear.fit.gram_sum_bound``; equal run
    to run; the batched solve of both keeps the same leaves (fit_ok), and
    the kernel's coefficients solve the twin's system within
    GRAM_RESIDUAL_TOL (relative residual). Returns max |diff| of A and
    B."""
    import torch
    from lightgbm_tpu_torch.linear import fit as LF

    got = LF.gram_sums(X, row_leaf, ghc, feat_idx, feat_mask)
    again = LF.gram_sums(X, row_leaf, ghc, feat_idx, feat_mask)
    want = LF.gram_sums_plain(X, row_leaf, ghc[:, 0], ghc[:, 1], feat_idx,
                              feat_mask)
    bound = LF.gram_sum_bound(X, row_leaf, ghc, feat_idx, feat_mask)
    sync(X.device)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("%s: the Gram sums differ run to run" % name)
    for fld in ("cnt", "vcnt"):
        if not torch.equal(getattr(got, fld), getattr(want, fld)):
            raise AssertionError("%s: %s differ" % (name, fld))
    err = 0.0
    for fld in ("A", "B"):
        d = (getattr(got, fld) - getattr(want, fld)).abs()
        over = d > getattr(bound, fld) * 1.0001 + 1e-30
        if bool(over.any()):
            raise AssertionError("%s: %s off by %.3g past its bound"
                                 % (name, fld, float(d[over].max())))
        err = max(err, float(d.max()) if d.numel() else 0.0)
    bk, ok_k = LF.solve_leaves(got, feat_mask, lam)
    _, ok_t = LF.solve_leaves(want, feat_mask, lam)
    if not torch.equal(ok_k, ok_t):
        raise AssertionError("%s: fit_ok differs at leaves %s" % (
            name, torch.nonzero(ok_k != ok_t).flatten().tolist()[:8]))
    # the kernel's coefficients solve the twin's system as a backward
    # stable f32 solve does (the coefficients themselves move with the
    # leaf's condition number, which at lambda 0 may be large)
    A_t = LF.ridge_system(want, feat_mask, lam)
    res = torch.linalg.vector_norm(
        (A_t @ bk[:, :, None])[:, :, 0] + want.B, dim=1)
    scale = torch.linalg.matrix_norm(A_t) * torch.linalg.vector_norm(
        bk, dim=1) + torch.linalg.vector_norm(want.B, dim=1)
    rel = (res / scale)[ok_k]
    if rel.numel() and float(rel.max()) > GRAM_RESIDUAL_TOL:
        raise AssertionError("%s: the kernel's coefficients leave a "
                             "relative residual %.3g on the twin's system"
                             % (name, float(rel.max())))
    return err


def check_dense_hist(name, op, leaf=-1, hdr=None, new_leaf=0):
    """The dense histogram kernel (``op`` an ops.histogram.DenseHistogram
    on the card) against its twin on the same rows: the count channel
    equal, g and h within ``dense_sum_bound`` of the selected rows' sum of
    |x| (the twin on |ghc|), bit-equal run to run. Returns max |diff|."""
    import torch
    from lightgbm_tpu_torch.ops import histogram as H

    got = op(leaf, hdr, new_leaf).clone()
    again = op(leaf, hdr, new_leaf).clone()
    want = H.dense_histogram_plain(op.bins, op.ghc, op.row_leaf, leaf,
                                   num_bins=op.num_bins, hdr=hdr,
                                   new_leaf=new_leaf)
    absx = H.dense_histogram_plain(op.bins, op.ghc.abs(), op.row_leaf, leaf,
                                   num_bins=op.num_bins, hdr=hdr,
                                   new_leaf=new_leaf)
    sync(op.bins.device)
    if not torch.equal(got, again):
        raise AssertionError("%s: not bit-equal run to run" % name)
    if not torch.equal(got[..., 2], want[..., 2]):
        raise AssertionError("%s: the count channels differ" % name)
    cnt = int(want[0, :, 2].sum())
    d = (got - want).abs()[..., :2]
    lim = absx[..., :2] * H.dense_sum_bound(cnt) + 1e-30
    if bool((d > lim).any()):
        raise AssertionError("%s: off by %.3g past its bound"
                             % (name, float(d.max())))
    return float(d.max())


def check_row_update(name, bins, row_leaf, go_left, hdr, new_leaf):
    """The row update kernel against its twin on copies: equal leaf ids.
    Returns 0.0."""
    from lightgbm_tpu_torch.ops import histogram as H

    a, b = row_leaf.clone(), row_leaf.clone()
    H.dense_row_update(bins, a, go_left, hdr, new_leaf)
    H.dense_row_update_plain(bins, b, go_left, hdr, new_leaf)
    sync(bins.device)
    return float(id_diff(name, a, b))


def check_router_u16(name, bins, log, bins_t=None, want=None):
    """The router over u16 bins (route_rows_u16) against the round-by-round
    plain router (``want``: the rows' known leaves, else
    learner.assign_leaves_plain): leaf ids equal. Returns 0.0."""
    from lightgbm_tpu_torch.learner import assign_leaves, assign_leaves_plain

    got = assign_leaves(bins, log, has_categorical=True, bins_t=bins_t)
    if want is None:
        want = assign_leaves_plain(bins, log, True)
    sync(bins.device)
    return float(id_diff(name, got, want))


def random_log(rng, dev, rounds, F, B, cat_frac=0.0):
    """A seeded split log (learner.TreeLog) of ``rounds`` splits over F
    features of B bins: round r splits one of leaves 0..r, numerical
    thresholds with movable-missing bins, about ``cat_frac`` categorical
    rounds with random go-left sets over all B bins."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.learner import TreeLog

    leaf = np.array([rng.randint(0, r + 1) for r in range(rounds)])
    feat = rng.randint(0, F, rounds)
    tbin = rng.randint(0, B - 1, rounds)
    kind = (rng.rand(rounds) < cat_frac).astype(np.int32)
    go = np.arange(B)[None, :] <= tbin[:, None]
    cats = rng.rand(rounds, B) < 0.5
    go = np.where(kind[:, None] > 0, cats, go)
    movable = rng.rand(rounds) < 0.3
    miss = rng.randint(0, B, rounds)
    dl = rng.rand(rounds) < 0.5

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a)).to(dtype).to(dev)

    z = torch.zeros((rounds, 3), dtype=torch.float32, device=dev)
    return TreeLog(
        num_splits=t([rounds], torch.int32), split_leaf=t(leaf, torch.int32),
        feature=t(feat, torch.int32), bin=t(tbin, torch.int32),
        kind=t(kind, torch.int32), default_left=t(dl, torch.bool),
        gain=z[:, 0], left_sum=z, right_sum=z, go_left=t(go, torch.bool),
        miss_bin=t(miss, torch.int32), movable=t(movable, torch.bool),
        leaf_value=torch.zeros(rounds + 1, device=dev),
        leaf_sum=torch.zeros((rounds + 1, 3), device=dev),
        row_leaf=torch.zeros(0, dtype=torch.int32, device=dev))


def wide_scan_case(dev, rng, B, F=12, cat=False):
    """Seeded (2, F, B, 3) children histograms past 256 bins on a 1/64
    grid, their pair row and the scan's meta and hyperparameters; with
    ``cat`` feature 2 categorical with B bins (ranks past 255)."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.ops.partition import split_pair
    from lightgbm_tpu_torch.ops.split import FeatureMeta, SplitHyper

    cnt = rng.randint(0, 40, (2, F, B)).astype(np.float64)
    g = np.round((rng.randn(2, F, B) * 2 + 0.01 * np.arange(B)) * 64) / 64
    h = np.round(np.abs(rng.randn(2, F, B)) * 64) / 64 + cnt / 64
    g = g * (cnt > 0)
    h = h * (cnt > 0)
    hists = np.stack([g, h, cnt], axis=-1)
    num_bins = np.full(F, B, np.int32)
    num_bins[5] = 300
    movable = np.zeros(F, bool)
    movable[1] = True
    miss = np.zeros(F, np.int32)
    miss[1] = B - 1
    is_cat = np.zeros(F, bool)
    hp = dict(min_data_in_leaf=20.0)
    if cat:
        is_cat[2] = True
        hp.update(has_categorical=True, max_cat_to_onehot=4,
                  min_data_per_group=10.0, max_cat_threshold=64)
    meta = FeatureMeta(
        num_bins=torch.as_tensor(num_bins).to(dev),
        movable_missing=torch.as_tensor(movable).to(dev),
        missing_bin=torch.as_tensor(miss).to(dev),
        is_categorical=torch.as_tensor(is_cat).to(dev),
        monotone=torch.zeros(F, dtype=torch.int8, device=dev),
        penalty=torch.ones(F, dtype=torch.float32, device=dev),
        cegb_coupled=torch.zeros(F, dtype=torch.float32, device=dev))
    ht = torch.as_tensor(hists.astype(np.float32)).to(dev)
    # each child's sums: its feature 0's bins (every feature sums alike up
    # to the grid's rounding, which the scan does not need)
    sums = ht[:, 0].sum(dim=1)
    pair = split_pair(sums, torch.zeros(2, device=dev),
                      torch.full((2,), float("-inf"), device=dev),
                      torch.full((2,), float("inf"), device=dev))
    return ht, pair, meta, SplitHyper(**hp), torch.ones(F, dtype=torch.bool,
                                                        device=dev)


def phase_linear_dense_kernels(dev, rng, n=300_000):
    """Phase 3j's kernels on seeded inputs: the Gram kernel against its
    twin (31 and 255 leaves, 8 and 16 features a leaf, NaN rows, an empty
    leaf, an under-determined one, out-of-bag rows; 300,000 rows); the
    dense histogram against its twin on u8 (255 bins) and u16 (1023 bins)
    rows: every row, a big and a small leaf, an empty leaf, a split's
    header (either child smaller) and a dead one; the row update against
    its twin (live and dead headers, u8 and u16); the split scan past 256
    bins (511, 1023 and 3000 bins, with a categorical feature of 1023
    bins) bit for bit against find_best_split on the card; the router over
    u16 bins against the plain router (254 numerical rounds, categorical
    rounds over 1023 bins, num_splits 0). Returns errs."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.learner import device_bins, route_layout
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.ops.partition import HDR_WORDS

    errs = {}
    for L, km, lam in ((31, 8, 0.0), (255, 16, 0.5)):
        key = "linear_gram/L%d_k%d" % (L, km)
        errs[key] = check_linear_gram(
            key, *gram_inputs(dev, rng, n, 24, L, km), lam)
    for B, F in ((255, 28), (1023, 28)):
        dt = np.uint8 if B <= 256 else np.uint16
        bins_np = rng.randint(0, B, (n, F)).astype(dt)
        bins = device_bins(bins_np, dev)
        ghc = torch.as_tensor(np.stack(
            [np.round(rng.randn(n) * 64) / 64, np.abs(np.round(
                rng.randn(n) * 64) / 64), (rng.rand(n) < 0.9)], axis=1)
            .astype(np.float32)).to(dev)
        leaf_np = rng.randint(0, 40, n)
        leaf_np[rng.rand(n) < 0.5] = 3
        row_leaf = torch.as_tensor(leaf_np.astype(np.int32)).to(dev)
        op = H.DenseHistogram(bins, ghc, row_leaf, B)
        tag = "dense_histogram/b%d" % B
        for name, leaf in (("all", -1), ("big", 3), ("small", 17),
                           ("empty", 99)):
            errs["%s/%s" % (tag, name)] = check_dense_hist(
                "%s/%s" % (tag, name), op, leaf)
        for name, ls, live in (("hdr_left", 1, 1), ("hdr_right", 0, 1)):
            hdr = torch.tensor([0, 0, 0, 5, ls, 3, live, 3],
                               dtype=torch.int32).to(dev)
            errs["%s/%s" % (tag, name)] = check_dense_hist(
                "%s/%s" % (tag, name), op, hdr=hdr, new_leaf=17)
        dead = torch.tensor([0, 0, 0, 5, 1, 3, 0, 3],
                            dtype=torch.int32).to(dev)
        op.out.fill_(7.0)
        op(hdr=dead, new_leaf=17)
        sync(dev)
        if not bool((op.out == 7.0).all()):
            raise AssertionError("%s: a dead header wrote" % tag)
        go = torch.as_tensor(rng.rand(B) < 0.5).to(dev)
        for name, live in (("live", 1), ("dead", 0)):
            hdr = torch.tensor([0, 0, 0, 7, 1, 3, live, 3],
                               dtype=torch.int32).to(dev)
            assert hdr.numel() == HDR_WORDS
            key = "dense_row_update/b%d/%s" % (B, name)
            errs[key] = check_row_update(key, bins, row_leaf, go, hdr, 40)
    for B, cat in ((511, False), (1023, False), (1023, True), (3000, False)):
        ht, pair, meta, hp, fmask = wide_scan_case(dev, rng, B, cat=cat)
        key = "split_scan/b%d%s" % (B, "_cat" if cat else "")
        errs[key] = check_split_scan(key, ht, pair, 2, meta, fmask, hp)
    F, B = 28, 1023
    bins = device_bins(rng.randint(0, B, (min(n, 65536), F))
                       .astype(np.uint16), dev)
    bt = route_layout(bins)
    for name, rounds, cat_frac, ns in (("tree254", 254, 0.0, 254),
                                       ("cat", 120, 0.5, 120),
                                       ("ns0", 60, 0.0, 0)):
        log_ = random_log(rng, dev, rounds, F, B, cat_frac)
        if ns != rounds:
            log_ = log_._replace(num_splits=torch.tensor(
                [ns], dtype=torch.int32, device=dev))
        key = "router_u16/" + name
        errs[key] = check_router_u16(key, bins, log_, bt)
    return errs


def capture_linear_fits(at):
    """Wrap the batched linear fit so that the calls numbered in ``at``
    keep their inputs (the tree's feature tables, the rows' leaves and the
    channels, cloned). Returns (the kept inputs by call, restore)."""
    import lightgbm_tpu_torch.linear as LIN
    from lightgbm_tpu_torch.linear.fit import leaf_feature_table

    orig = LIN.fit_linear_leaves
    calls, kept = [0], {}

    def rec(tree, ds, row_leaf, ghc, **kw):
        i = calls[0]
        calls[0] += 1
        if i in at:
            kept[i] = (leaf_feature_table(tree, ds, kw["num_leaves_cap"]),
                       ds, row_leaf.clone(), ghc.clone(), kw["lam"])
        return orig(tree, ds, row_leaf, ghc, **kw)

    LIN.fit_linear_leaves = rec

    def restore():
        LIN.fit_linear_leaves = orig

    return kept, restore


def linear_run(dev, data, lam, trees, leaves, capture=(),
               linear_device="auto"):
    """Linear trees at full width per iteration with phase 3's valid set
    (launch counts zeroed just before, read just after); the calls of the
    batched fit numbered in ``capture`` keep their inputs. Returns
    (booster, counts, summary, kept inputs)."""
    import hashlib
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import kernels

    X, y, Xv, yv = data
    params = train_params(dev, leaves, {"linear_tree": True,
                                        "linear_lambda": lam,
                                        "linear_device": linear_device})
    train = lgt.Dataset(X, label=y, params=params)
    train.construct()
    valid = lgt.Dataset(Xv, label=yv, reference=train)
    valid.construct()
    kept, restore = capture_linear_fits(set(capture))
    sync(dev)
    kernels.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        bst = lgt.train(dict(params), train, trees, valid_sets=[valid])
        sync(dev)
        wall = time.perf_counter() - t0
    finally:
        restore()
    counts = kernels.launch_counts()
    g = bst.inner
    text = bst.model_to_string()
    auc = auc_np(yv, bst.predict(Xv))
    valid_auc = [v for _, m, v, _ in g.eval_valid() if m == "auc"][0]
    if abs(auc - valid_auc) > 1e-5:
        raise AssertionError("phase 3j linear: predicted valid auc %.7f, "
                             "the valid scores' %.7f" % (auc, valid_auc))
    loaded = lgt.Booster({"device_type": dev.type}, model_str=text)
    d = float(abs(loaded.predict(Xv[:5000]) - bst.predict(Xv[:5000])).max())
    if d > 1e-6:
        raise AssertionError("phase 3j linear: the model read back from "
                             "its text predicts %.3g away" % d)
    fitted = sum(len(c) > 0 for t in g.models
                 for c in t.leaf_coeff.values())
    s = dict(trees=trees, linear_lambda=lam,
             wall_per_tree_ms=wall / trees * 1e3,
             model_sha256=hashlib.sha256(text.encode()).hexdigest(),
             leaves=[t.num_leaves for t in g.models], valid_auc=auc,
             linear_leaves=fitted, train_logloss=bst.eval_train()[1][2],
             text_round_trip_max_diff=d)
    log("phase 3j linear lambda %g: %d trees per iteration in %.1f ms a "
        "tree, leaves %s, %d leaves with coefficients, valid auc %.5f, "
        "train logloss %.7f, sha256 %s; launches %s"
        % (lam, trees, s["wall_per_tree_ms"], s["leaves"], fitted, auc,
           s["train_logloss"], s["model_sha256"], counts))
    return bst, counts, s, kept


def linear_card_vs_host(dev, data, rows, trees, leaves):
    """Linear trees on the first ``rows`` rows on the card (the Gram
    kernel) and on the host (the twin, linear_device=on): the splits that
    agree, and the train logloss within LINEAR_METRIC_TOL."""
    import lightgbm_tpu_torch as lgt
    X, y = data[0][:rows], data[1][:rows]
    params = train_params(dev, leaves, {"linear_tree": True,
                                        "linear_device": "on"})
    bst = lgt.train(params, lgt.Dataset(X, label=y, params=params), trees)
    ca, lc = tree_splits(bst), bst.eval_train()[1][2]
    del bst
    out = {}

    def check(host):
        lh = host["eval_train"][1][2]
        agree, total, _ = split_agreement(ca, host["splits"])
        log("phase 3j card vs host linear: %d rows x %d trees x %d leaves; "
            "%d of %d splits agree; train logloss card %.9f host %.9f "
            "(|diff| %.3g, limit %.1g)" % (rows, trees, leaves, agree, total,
                                          lc, lh, abs(lc - lh),
                                          LINEAR_METRIC_TOL))
        if not abs(lc - lh) <= LINEAR_METRIC_TOL:
            raise AssertionError("phase 3j linear: train logloss card %.9f "
                                 "host %.9f" % (lc, lh))
        out.update(splits_agree=agree, splits=total, logloss_card=lc,
                   logloss_host=lh)

    host_run(params, X, y, trees, check)
    return out


def dense_run(dev, data, name, extra, trees, per_iter, leaves):
    """The dense builder at full width: fused ``trees`` trees through the
    device tree loop (launch counts zeroed just before, read just after),
    then ``per_iter`` trees per iteration with phase 3's valid set (the
    learner's ``train``: on the card the device tree loop, outside the
    CUDA graph; the valid rows routed on the card) whose model must be
    the first fused trees' byte for byte, then ``trees`` more
    fused trees (the steady wall a tree). Returns (fused booster, counts,
    summary)."""
    import hashlib
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import kernels

    X, y, Xv, yv = data
    params = train_params(dev, leaves, extra)
    train = lgt.Dataset(X, label=y, params=params)
    train.construct()
    sync(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    bst = lgt.train(dict(params), train, trees)
    sync(dev)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    g = bst.inner
    if g._fused is None or not g.learner.dense:
        raise AssertionError("phase 3j %s: not the dense builder's fused "
                             "path" % name)
    text = bst.model_to_string()
    s = dict(trees=trees, wall_per_tree_ms=wall / trees * 1e3,
             model_sha256=hashlib.sha256(text.encode()).hexdigest(),
             leaves=[t.num_leaves for t in g.models],
             num_bin=g.learner.num_bin,
             bins_dtype=str(g.learner.bins.dtype),
             train_logloss=bst.eval_train()[1][2],
             valid_auc=auc_np(yv, bst.predict(Xv)))
    valid = lgt.Dataset(Xv, label=yv, reference=train)
    valid.construct()
    sync(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    eager = lgt.train(dict(params), train, per_iter, valid_sets=[valid])
    sync(dev)
    s["per_iteration_wall_per_tree_ms"] = \
        (time.perf_counter() - t0) / per_iter * 1e3
    s["per_iteration_launches"] = kernels.launch_counts()
    if model_text(eager, per_iter) != model_text(bst, per_iter):
        raise AssertionError("phase 3j %s: the per-iteration model is not "
                             "the first fused trees' byte for byte" % name)
    ev = [v for _, m, v, _ in eager.inner.eval_valid() if m == "auc"][0]
    pv = auc_np(yv, eager.predict(Xv))
    if abs(ev - pv) > 1e-5:
        raise AssertionError("phase 3j %s: valid auc from the routed valid "
                             "scores %.7f, predicted %.7f" % (name, ev, pv))
    s["per_iteration_equal"] = True
    sync(dev)
    t0 = time.perf_counter()
    g.train_block(trees)
    g.finish_fused("steady")
    sync(dev)
    s["steady_wall_per_tree_ms"] = (time.perf_counter() - t0) / trees * 1e3
    log("phase 3j %s: %d fused trees (%s bins, %d of them) in %.1f ms a tree "
        "with the first eager tree and the capture, %.1f ms a tree in a "
        "second block, %.1f ms a tree per iteration; leaves %s, train "
        "logloss %.7f, valid auc %.5f, sha256 %s; launches %s"
        % (name, trees, s["bins_dtype"], s["num_bin"], s["wall_per_tree_ms"],
           s["steady_wall_per_tree_ms"], s["per_iteration_wall_per_tree_ms"],
           s["leaves"], s["train_logloss"], s["valid_auc"],
           s["model_sha256"], counts))
    return bst, counts, s


def dense_full_width(bst, data, dev, errs, tag, timed):
    """Kernels D, S and R against their twins on a fused dense learner's
    inputs at full width (the fused model's gradients): a tree grown on
    them through the device tree loop equal field by field to the
    per-split host loop's (build_tree) on the card, the histogram of
    every row (the root) and of the smallest leaf of that tree
    (a deep leaf), the row update of that leaf, the split scan of the root
    and the deep leaf as a pair of children, and the router over the
    training rows (equal to the loop's leaf ids) and the valid rows (equal
    to the plain router). With ``timed``, each one's ms, plain ms and
    bytes. Returns the timings."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.learner import assign_leaves, assign_leaves_plain
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.ops import partition as P
    from lightgbm_tpu_torch.ops.split import find_best_split

    g = bst.inner
    lrn = g.learner
    grad, hess = g.objective.get_gradients(g.train_score.score)
    ghc = torch.stack([grad, hess, torch.ones_like(grad)], dim=1)
    log_ = lrn.train_device(ghc)
    row_leaf = log_.row_leaf.clone()
    # the per-split host loop (build_tree) on the card grows the same tree
    host_log = lrn.train_host_loop(ghc)
    for fld, a, b in zip(log_._fields, log_, host_log):
        if not torch.equal(a, b):
            raise AssertionError("phase 3j %s: the device tree loop's %s "
                                 "differs from the per-split host loop's"
                                 % (tag, fld))
    bins, B = lrn.bins, lrn.num_bin
    n, F = bins.shape
    counts = torch.bincount(row_leaf.long(), minlength=lrn.num_leaves)
    deep = int(torch.argmin(torch.where(counts > 0, counts,
                                        counts.max() + 1)))
    m_deep = int(counts[deep])
    zero = torch.zeros(n, dtype=torch.int32, device=dev)
    root_op = H.DenseHistogram(bins, ghc, zero, B)
    leaf_op = H.DenseHistogram(bins, ghc, row_leaf, B)
    errs["dense_histogram/%s/root" % tag] = check_dense_hist(
        "dense_histogram/%s/root" % tag, root_op, -1)
    errs["dense_histogram/%s/deep" % tag] = check_dense_hist(
        "dense_histogram/%s/deep" % tag, leaf_op, deep)
    root_h, deep_h = root_op(-1).clone(), leaf_op(deep).clone()
    go = torch.arange(B, device=dev) <= B // 3
    hdr = torch.tensor([0, 0, 0, 0, 1, 3, 1, deep], dtype=torch.int32
                       ).to(dev)
    errs["dense_row_update/%s" % tag] = check_row_update(
        "dense_row_update/%s" % tag, bins, row_leaf, go, hdr,
        lrn.num_leaves)
    hists = torch.stack([root_h, deep_h])
    sums = hists[:, 0].sum(dim=1)
    pair = P.split_pair(sums, torch.zeros(2, device=dev),
                        torch.full((2,), float("-inf"), device=dev),
                        torch.full((2,), float("inf"), device=dev))
    fmask = torch.ones(F, dtype=torch.bool, device=dev)
    errs["split_scan/%s" % tag] = check_split_scan(
        "split_scan/%s" % tag, hists, pair, 3, lrn.meta, fmask, lrn.hp)
    # the loop's own scans, the sibling folded in, at its first and last
    # live slots
    for where, s in (("root", 0), ("deep", last_live_slot(lrn, ghc))):
        key = "split_scan/%s/fold_%s" % (tag, where)
        errs[key] = check_split_fold(key, *fold_inputs_at(lrn, ghc, s), s)
    errs["router_u16/%s/train" % tag] = check_router_u16(
        "router_u16/%s/train" % tag, bins, log_, lrn.bins_t, row_leaf)
    vbins = g._valid_bins(valid_dataset_of(bst, data))
    errs["router_u16/%s/valid" % tag] = check_router_u16(
        "router_u16/%s/valid" % tag, vbins, log_)
    if not timed:
        return {}
    t = {}
    t["hist_root"] = (cuda_ms(lambda: root_op(-1)),
                      device_ms(lambda: root_op(-1)),
                      cuda_ms(lambda: H.dense_histogram_plain(
                          bins, ghc, zero, -1, num_bins=B), iters=2,
                          warmup=1))
    t["hist_deep"] = (cuda_ms(lambda: leaf_op(deep)),
                      device_ms(lambda: leaf_op(deep)),
                      cuda_ms(lambda: H.dense_histogram_plain(
                          bins, ghc, row_leaf, deep, num_bins=B), iters=2,
                          warmup=1))
    # index_add_ of the selected rows' channels into the flat (F * B, 3)
    # histogram: one torch call of the same function (its inputs built
    # outside the timing)
    sel = torch.nonzero(row_leaf == deep).flatten()
    for key, rows_ in (("lib_root", None), ("lib_deep", sel)):
        b_sel = bins.long() if rows_ is None else bins.long()[rows_]
        flat = (b_sel + torch.arange(F, device=dev) * B).reshape(-1)
        src = (ghc if rows_ is None else ghc[rows_])[:, None, :] \
            .expand(-1, F, 3).reshape(-1, 3).contiguous()
        acc = torch.zeros((F * B, 3), dtype=torch.float32, device=dev)
        t[key] = cuda_ms(lambda: acc.index_add_(0, flat, src), iters=5)
        del b_sel, flat, src
    # the scan as the loop launches it (the sibling folded in) at its last
    # live slot
    _, call = scan_call_at(lrn, ghc, last_live_slot(lrn, ghc))
    t["scan"] = (cuda_ms(call), device_ms(call),
                 cuda_ms(lambda: find_best_split(
                     hists, pair[0:6].view(2, 3), lrn.meta, fmask, lrn.hp,
                     parent_output=pair[6:8], leaf_lower=pair[8:10],
                     leaf_upper=pair[10:12], node_depth=3), iters=5,
                     warmup=1))
    bt = lrn.bins_t
    t["route"] = (cuda_ms(lambda: assign_leaves(bins, log_, True,
                                                bins_t=bt)),
                  device_ms(lambda: assign_leaves(bins, log_, True,
                                                  bins_t=bt)),
                  cuda_ms(lambda: assign_leaves_plain(bins, log_, True),
                          iters=2, warmup=1))
    rl = row_leaf.clone()
    t["update"] = (cuda_ms(lambda: H.dense_row_update(bins, rl, go, hdr,
                                                      deep)),
                   device_ms(lambda: H.dense_row_update(bins, rl, go, hdr,
                                                        deep)),
                   cuda_ms(lambda: H.dense_row_update_plain(bins, rl, go,
                                                            hdr, deep),
                           iters=5, warmup=1))
    elem = bins.element_size()
    ns = int(log_.num_splits[0])
    t.update(n=n, F=F, B=B, m_deep=m_deep, elem=elem, splits=ns,
             update_rows=m_deep)
    log("phase 3j %s kernels at N = %d, F = %d, B = %d (%d-byte bins): "
        "dense histogram root %.4f ms (device %.4f, twin %.1f, index_add_ "
        "%.3f), deep leaf of %d rows %.4f ms (device %.4f, twin %.1f, "
        "index_add_ %.3f); split scan %.4f ms (device %.4f, "
        "find_best_split %.3f); router %d splits %.4f ms (device %.4f, "
        "plain %.2f); row update %.4f ms (device %.4f, twin %.3f)"
        % (tag, n, F, B, elem, *t["hist_root"], t["lib_root"], m_deep,
           *t["hist_deep"], t["lib_deep"], *t["scan"], ns, *t["route"],
           *t["update"]))
    return t


def valid_dataset_of(bst, data):
    """Phase 3's valid rows binned against ``bst``'s training set."""
    import lightgbm_tpu_torch as lgt
    ds = getattr(bst, "_smoke_valid", None)
    if ds is None:
        ds = lgt.Dataset(data[2], label=data[3],
                         reference=bst.train_dataset).construct()
        bst._smoke_valid = ds
    return ds


def time_linear_gram(kept, dev, errs, timed=True):
    """Kernel L against its twin at the captured fits (the middle and the
    last tree of a full-width run): the Gram sums, fit_ok and the
    coefficients (check_linear_gram); with ``timed`` each one timed.
    Returns the last one's timings and bytes (None untimed)."""
    import torch
    from lightgbm_tpu_torch.linear import fit as LF

    t = None
    for i in sorted(kept):
        tables, ds, row_leaf, ghc, lam = kept[i]
        fi, fm = (torch.as_tensor(x).to(dev) for x in tables)
        X = LF._device_raw(ds, dev)
        key = "linear_gram/full_width/fit%d" % i
        errs[key] = check_linear_gram(key, X, row_leaf, ghc, fi, fm, lam)
        if not timed:
            continue
        n, (L, km) = row_leaf.shape[0], fi.shape
        ms = cuda_ms(lambda: LF.gram_sums(X, row_leaf, ghc, fi, fm))
        dms = device_ms(lambda: LF.gram_sums(X, row_leaf, ghc, fi, fm))
        plain = cuda_ms(lambda: LF.gram_sums_plain(X, row_leaf, ghc[:, 0],
                                                   ghc[:, 1], fi, fm),
                        iters=2, warmup=1)
        k_row = fm.sum(dim=1).index_select(0, row_leaf.long())
        kp1 = km + 1
        w = kp1 * kp1 + kp1 + 2
        byts = n * (4 + 8) + int(k_row.sum()) * 4 + L * w * 4
        ops = n * (kp1 * kp1 + kp1) * 2
        t = dict(ms=ms, device_ms=dms, plain_ms=plain, bytes=byts, ops=ops,
                 shape=dict(rows=n, leaves=L, k=km,
                            features_used=int(k_row.sum())))
        log("phase 3j linear_gram fit %d at %d rows, %d leaves, k = %d: "
            "%.4f ms (device %.4f, twin %.2f), %d feature reads"
            % (i, n, L, km, ms, dms, plain, int(k_row.sum())))
    return t


def phase_linear_dense(dev, data, card, leaves=255, timed=True, seed=0,
                       linear_trees=LINEAR_TREES, dense_trees=DENSE_TREES,
                       per_iter=DENSE_PER_ITER_TREES,
                       host_rows=LINEAR_HOST_ROWS,
                       host_trees=LINEAR_HOST_TREES,
                       host_leaves=LINEAR_HOST_LEAVES, kernel_rows=300_000,
                       linear_device="auto"):
    """Phase 3j: (a) linear trees at full width per iteration with the
    valid set, at the default linear_lambda and at LINEAR_LAMBDA: kernel
    L against its twin at the middle and the last fit; sha256 equal
    across two runs of the default; the model read back from its text
    predicts the same; valid AUC above the plain GBDT's at the same trees;
    card against host at ``host_rows`` rows. (b) the dense builder at
    max_bin 1023 (u16 bins) and at tree_builder=dense with 255 bins:
    fused through the device loop against per iteration (byte-equal), and
    kernels D, S and R against their twins at the root and a deep leaf.
    The seeded kernel checks first (phase_linear_dense_kernels at
    ``kernel_rows`` rows). ``linear_device`` is the linear runs' knob
    (``auto``: the Gram kernel on the card; ``on`` takes the batched fit
    on the host too). Returns
    (summary, {config: counts}, errs, the kernels-line rows)."""
    import numpy as np

    t_start = time.perf_counter()
    errs = phase_linear_dense_kernels(dev, np.random.RandomState(seed + 61),
                                      n=kernel_rows)
    summary, counts_by = {}, {}
    # the fits run from the second tree on (the first tree keeps constant
    # leaves): the middle one and the last one
    fits = linear_trees - 1
    mid, last = (fits - 1) // 2, fits - 1
    runs = {}
    for name, lam in (("linear", 0.0), ("linear_lambda", LINEAR_LAMBDA)):
        bst, counts, s, kept = linear_run(
            dev, data, lam, linear_trees, leaves,
            capture=(mid, last) if name == "linear" else (),
            linear_device=linear_device)
        if dev.type == "cuda" and counts.get("linear_gram", 0) \
                != linear_trees - 1:
            raise AssertionError("phase 3j %s: %d Gram launches for %d "
                                 "fits" % (name, counts.get("linear_gram", 0),
                                           linear_trees - 1))
        summary[name], counts_by[name] = s, counts
        runs[name] = (bst, kept)
    _, _, again, _ = linear_run(dev, data, 0.0, linear_trees, leaves,
                                linear_device=linear_device)
    if again["model_sha256"] != summary["linear"]["model_sha256"]:
        raise AssertionError("phase 3j linear: sha256 %s then %s"
                             % (summary["linear"]["model_sha256"],
                                again["model_sha256"]))
    summary["linear"]["sha256_stable"] = True
    batched = linear_device == "on" or (linear_device == "auto"
                                        and dev.type == "cuda")
    if batched and sorted(runs["linear"][1]) != [mid, last]:
        raise AssertionError("phase 3j: the batched fit ran %d times, not "
                             "%d" % (len(runs["linear"][1]), fits))
    t_gram = time_linear_gram(runs["linear"][1], dev, errs,
                              timed and dev.type == "cuda")
    import lightgbm_tpu_torch as lgt
    X, y, Xv, yv = data
    params = train_params(dev, leaves)
    plain = lgt.train(dict(params), lgt.Dataset(X, label=y, params=params),
                      linear_trees)
    plain_auc = auc_np(yv, plain.predict(Xv))
    summary["linear"]["plain_gbdt_valid_auc"] = plain_auc
    log("phase 3j valid auc after %d trees: linear %.5f, lambda %g %.5f, "
        "plain GBDT %.5f" % (linear_trees, summary["linear"]["valid_auc"],
                             LINEAR_LAMBDA,
                             summary["linear_lambda"]["valid_auc"],
                             plain_auc))
    if not summary["linear"]["valid_auc"] > plain_auc:
        raise AssertionError("phase 3j: linear valid auc %.5f not above the "
                             "plain GBDT's %.5f"
                             % (summary["linear"]["valid_auc"], plain_auc))
    del plain, runs
    summary["linear"]["card_vs_host"] = linear_card_vs_host(
        dev, data, host_rows, host_trees, host_leaves)
    t_dense = {}
    for name, extra in DENSE_CONFIGS.items():
        bst, counts, s = dense_run(dev, data, name, extra, dense_trees,
                                   per_iter, leaves)
        L1 = leaves - 1
        want = {"dense_histogram": dense_trees * leaves,
                "dense_row_update": dense_trees * L1,
                "split_scan": dense_trees * L1,
                "split_commit": dense_trees * leaves}
        router = "route_rows_u16" if is_u16(extra) else "route_rows"
        # per iteration too the trees grow through the card's kernels
        per_iter_want = ("dense_histogram", "dense_row_update", "split_scan",
                         "split_commit", router)
        if dev.type == "cuda" and (
                any(counts.get(k, 0) != v for k, v in want.items())
                or any(s["per_iteration_launches"].get(k, 0) <= 0
                       for k in per_iter_want)):
            raise AssertionError("phase 3j %s launches %s (per iteration "
                                 "%s), want %s and %s"
                                 % (name, counts, s["per_iteration_launches"],
                                    want, per_iter_want))
        summary[name], counts_by[name] = s, counts
        t_dense[name] = dense_full_width(bst, data, dev, errs, name,
                                         timed and name == "u16_1023")
        del bst
    rows = {}
    if timed and dev.type == "cuda":
        rows = linear_dense_rows(errs, t_gram, t_dense["u16_1023"])
    log("phase 3j took %.1f s (%s)" % (time.perf_counter() - t_start, card))
    return summary, counts_by, errs, rows


def linear_dense_launches(counts_by, summary):
    """The launches of phase 3j's kernels on its main paths: the Gram
    kernel in both linear runs, the dense kernels and the wide scan in the
    fused dense runs, the u16 router routing the valid rows per
    iteration."""
    dense = [counts_by[k] for k in DENSE_CONFIGS]
    return {"linear_gram": sum(counts_by[k].get("linear_gram", 0)
                               for k in ("linear", "linear_lambda")),
            "dense_histogram": sum(c.get("dense_histogram", 0)
                                   for c in dense),
            "dense_row_update": sum(c.get("dense_row_update", 0)
                                    for c in dense),
            "split_scan_b1023": counts_by["u16_1023"].get("split_scan", 0),
            "route_rows_u16": summary["u16_1023"]["per_iteration_launches"]
            .get("route_rows_u16", 0)}


def is_u16(extra):
    """Whether a phase 3j dense configuration bins past 256 (u16)."""
    return extra.get("max_bin", 255) > 256


def linear_dense_rows(errs, tg, td):
    """The kernels-line rows of phase 3j's kernels, their bytes and ops
    for bound_row."""
    n, F, B, elem = td["n"], td["F"], td["B"], td["elem"]
    m = td["m_deep"]

    def err(prefix):
        return max(v for k, v in errs.items() if k.startswith(prefix))

    def timed(key):
        ms, dms, plain = td[key]
        return dict(ms=ms, device_ms=dms, plain_ms=plain)

    out_b = F * B * 12
    rows = {
        "linear_gram": dict(
            route="cuda", source="lightgbm_tpu_torch/csrc/linear_gram.cu",
            replaces="lightgbm_tpu/linear/fit.py:75 (fit_leaves_impl's Gram "
                     "sums, XLA; no pallas_call)",
            max_abs_err=err("linear_gram/"), ms=tg["ms"],
            device_ms=tg["device_ms"], plain_ms=tg["plain_ms"],
            library_ms=None, shape=tg["shape"], bytes=tg["bytes"],
            ops=tg["ops"]),
        "dense_histogram": dict(
            route="cuda",
            source="lightgbm_tpu_torch/csrc/dense_histogram.cu",
            replaces="lightgbm_tpu/ops/histogram.py:73 (build_histogram in "
                     "learner.py:292 hist_of_leaf, XLA; no pallas_call)",
            max_abs_err=err("dense_histogram/"), **timed("hist_deep"),
            library_ms=td["lib_deep"], rows_selected=m,
            root=dict(zip(("ms", "device_ms", "plain_ms"), td["hist_root"]),
                      library_ms=td["lib_root"],
                      bound_ms=(4 * n + n * (F * elem + 12) + out_b)
                      / PEAK_BYTES_PER_S * 1e3),
            bytes=4 * n + m * (F * elem + 12) + out_b, ops=3 * m * F),
        "dense_row_update": dict(
            route="cuda",
            source="lightgbm_tpu_torch/csrc/dense_histogram.cu",
            replaces="lightgbm_tpu/learner.py:349 (the dense builder's row "
                     "update, XLA; no pallas_call)",
            max_abs_err=err("dense_row_update/"), **timed("update"),
            library_ms=None, rows_on_parent=td["update_rows"],
            bytes=4 * n + td["update_rows"] * (elem + 4), ops=n),
        "split_scan_b1023": dict(
            route="cuda", source="lightgbm_tpu_torch/csrc/split_scan.cu",
            replaces="lightgbm_tpu/ops/split.py:find_best_split (XLA; no "
                     "pallas_call), past 256 bins",
            max_abs_err=err("split_scan/b"), **timed("scan"),
            library_ms=None, bins=B, status="redesigned PR 20",
            bytes=4 * F * B * 12 + 48 + 2 * (64 + B), ops=2 * 4 * F * B * 13),
        "route_rows_u16": dict(
            route="cuda", source="lightgbm_tpu_torch/csrc/route_rows.cu",
            replaces="lightgbm_tpu/ops/route.py:88 (route_rows; u16 bins "
                     "take the JAX learner.py:1560 round-by-round loop)",
            max_abs_err=err("router_u16/"), **timed("route"),
            library_ms=None, splits=td["splits"],
            bytes=F * n * elem + 4 * n, ops=n * 8)}
    return rows


# --------------------------------------------------------------- file phase

#: the file phase: rows of its CSV files, cut from the 2M training rows to
#: bound the time it takes to write them, and the trees it trains
FILE_TRAIN_ROWS = 200_000
FILE_VALID_ROWS = 20_000
FILE_TREES = 8


def write_csv(path, X, y):
    """label, then the features; every value is a multiple of 1/1024, so
    ten fractional digits print it exactly."""
    import numpy as np
    np.savetxt(path, np.column_stack([y, X]), delimiter=",", fmt="%.10f")


def construct_routes(dev, X, y, leaves):
    """``Dataset.construct`` of (X, y) by the native route and by the numpy
    route (``construct_dataset(native=False)``): seconds, bins byte-equal."""
    import numpy as np
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.dataset import construct_dataset

    params = train_params(dev, leaves)
    t0 = time.perf_counter()
    native = lgt.Dataset(X, label=y, params=params).construct()
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = construct_dataset(X, Config.from_params(params), label=y,
                              native=False)
    t_numpy = time.perf_counter() - t0
    if not np.array_equal(native.binned, plain.binned):
        raise AssertionError("native and numpy binning disagree")
    log("construct: %d x %d rows, native %.2f s, numpy %.2f s (ratio "
        "%.3f), bins byte-equal" % (X.shape[0], X.shape[1], t_native,
                                    t_numpy, t_native / t_numpy))
    return dict(rows=int(X.shape[0]), native_s=t_native, numpy_s=t_numpy,
                ratio=t_native / t_numpy)


def phase_file(dev, data, leaves, card):
    """The file-driven path: the native constructs at full size against
    numpy, then CSV files through ``lightgbm_tpu_torch.cli`` on the card
    (train, predict, save_binary, train from the ``.bin``, and one
    ``python -m lightgbm_tpu_torch`` subprocess), each model byte-equal to
    ``train`` on the same arrays in this run. Returns (summary, launch
    counts of the CLI's train and of the trained booster's predict)."""
    import hashlib
    import numpy as np
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import cli, io_native
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io import load_text_file
    from lightgbm_tpu_torch.ops import kernels

    X, y, Xv, yv = data
    summary = {"construct": construct_routes(
        dev, np.concatenate([X, Xv]), np.concatenate([y, yv]), leaves)}
    Xf, yf = X[:FILE_TRAIN_ROWS], y[:FILE_TRAIN_ROWS]
    Xfv, yfv = Xv[:FILE_VALID_ROWS], yv[:FILE_VALID_ROWS]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_file_") as d:
        train_csv = os.path.join(d, "train.csv")
        valid_csv = os.path.join(d, "valid.csv")
        t0 = time.perf_counter()
        write_csv(train_csv, Xf, yf)
        write_csv(valid_csv, Xfv, yfv)
        summary["write_s"] = time.perf_counter() - t0
        params = {"objective": "binary", "max_bin": 255,
                  "num_leaves": leaves, "num_iterations": FILE_TREES,
                  "verbosity": -1, "device_type": dev.type}
        # the subprocess, started now, runs beside the rest (its own copy
        # of the CSV: the phase's directory goes before it is collected)
        sub_dir = tempfile.mkdtemp(prefix="chip_smoke_sub_")
        sub_csv = os.path.join(sub_dir, "train.csv")
        with open(train_csv, "rb") as f, open(sub_csv, "wb") as g:
            g.write(f.read())
        conf = os.path.join(sub_dir, "train.conf")
        with open(conf, "w") as f:
            f.write("".join("%s = %s\n" % kv for kv in dict(
                params, task="train", data=sub_csv,
                output_model=os.path.join(sub_dir, "sub.txt")).items()))
        env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        with open(os.path.join(sub_dir, "out.txt"), "w") as out:
            sub = Started(subprocess.Popen(
                [sys.executable, "-m", "lightgbm_tpu_torch",
                 "config=" + conf], cwd=sub_dir, env=env, stdout=out,
                stderr=subprocess.STDOUT))

        # the in-memory model: parse and bin natively, train on the card
        t0 = time.perf_counter()
        Xp, yp, _, _, _ = load_text_file(train_csv,
                                         Config.from_params(params))
        summary["parse_s"] = time.perf_counter() - t0
        for a, b in ((Xp, Xf), (yp, yf)):
            if not np.array_equal(np.asarray(a).view(np.uint64),
                                  np.ascontiguousarray(b).view(np.uint64)):
                raise AssertionError("the parsed CSV differs from the "
                                     "arrays written")
        t0 = time.perf_counter()
        ds = lgt.Dataset(Xp, label=yp, params=dict(params))
        ds.construct()
        summary["construct_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        bst = lgt.train(dict(params), ds)
        want = bst.model_to_string()
        sync(dev)
        summary["train_s"] = time.perf_counter() - t0

        def run_cli(args, expect=None):
            sync(dev)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            cli.main(args)
            sync(dev)
            secs = time.perf_counter() - t0
            counts = kernels.launch_counts()
            for name in (expect or ()) if dev.type == "cuda" else ():
                if counts.get(name, 0) <= 0:
                    raise AssertionError("cli %s never launched %s"
                                         % (args[0], name))
            return secs, counts

        def model_text(path):
            with open(path) as f:
                return f.read()

        arg = ["%s=%s" % kv for kv in params.items()]
        model = os.path.join(d, "model.txt")
        summary["cli_train_s"], train_counts = run_cli(
            ["task=train", "data=" + train_csv, "output_model=" + model]
            + arg, expect=("one_kernel_split", "split_commit", "route_rows"))
        if model_text(model) != want:
            raise AssertionError("the CLI model differs from train's on "
                                 "the same arrays")
        # the trained booster has bin mappers, so it predicts through the
        # forest kernel; a model read from its file has none and predicts
        # over raw thresholds, in both packages (boosting._forest_model):
        # here through the raw-threshold walk
        sync(dev)
        kernels.reset_launch_counts()
        ref = bst.predict(Xfv)
        sync(dev)
        predict_counts = kernels.launch_counts()
        if dev.type == "cuda" and predict_counts.get("forest_predict",
                                                     0) <= 0:
            raise AssertionError("predict never launched forest_predict")
        pred = os.path.join(d, "pred.txt")
        summary["cli_predict_s"], _ = run_cli(
            ["task=predict", "data=" + valid_csv, "input_model=" + model,
             "output_result=" + pred, "device_type=" + dev.type,
             "verbosity=-1"], expect=("forest_raw",))
        summary["predict_max_abs_err"] = check_scores(
            "cli predict", np.loadtxt(pred), ref)
        summary["cli_save_binary_s"], _ = run_cli(
            ["task=save_binary", "data=" + train_csv] + arg)
        from_bin = os.path.join(d, "from_bin.txt")
        summary["cli_train_bin_s"], _ = run_cli(
            ["task=train", "data=" + train_csv + ".bin",
             "output_model=" + from_bin] + arg)
        if model_text(from_bin) != want:
            raise AssertionError("the model from the .bin differs")
    summary["model_sha256"] = hashlib.sha256(want.encode()).hexdigest()
    summary["host_build_s"] = dict(io_native.BUILD_SECONDS)
    log("file: %d + %d rows written in %.1f s; parse %.2f s, construct "
        "%.2f s, train %.2f s (%d trees x %d leaves); cli train %.2f s, "
        "predict %.2f s, save_binary %.2f s, train from .bin %.2f s; "
        "every model byte-equal (%s)"
        % (len(Xf), len(Xfv), summary["write_s"], summary["parse_s"],
           summary["construct_s"], summary["train_s"], FILE_TREES, leaves,
           summary["cli_train_s"], summary["cli_predict_s"],
           summary["cli_save_binary_s"], summary["cli_train_bin_s"],
           summary["model_sha256"][:16]))

    def check_sub(res):
        rc, secs = res
        try:
            with open(os.path.join(sub_dir, "out.txt")) as f:
                tail = f.read()[-3000:]
            if rc != 0:
                raise AssertionError("python -m lightgbm_tpu_torch exited "
                                     "%d:\n%s" % (rc, tail))
            with open(os.path.join(sub_dir, "sub.txt")) as f:
                if f.read() != want:
                    raise AssertionError("the subprocess's model differs")
        finally:
            shutil_rmtree(sub_dir)
        summary["subprocess_s"] = secs
        log("file: python -m lightgbm_tpu_torch %.1f s (started before the "
            "CLI runs above), its model byte-equal (%s)"
            % (secs, summary["model_sha256"][:16]))

    host_later(sub, check_sub)
    log("file: launches, cli train %s; predict %s (%s)"
        % (train_counts, predict_counts, card))
    return summary, {"train": train_counts, "predict": predict_counts}


# ------------------------------------------------------------- phase 3k
#
# The API surface and online training (slice 17): cv, the scikit-learn
# classifier, the reset_parameter schedule, refit, pred_contrib,
# convert_model and a PredictServer that refits, then continues, its
# model from /ingest while four threads post /predict.

#: phase 3k's training settings: the defaults the API takes (on the card
#: tpu_split_kernel=auto runs the one-kernel split)
API_PARAMS = {"objective": "binary", "max_bin": 255, "verbosity": -1}
API_CV_FOLDS = 3
API_CV_ROUNDS = 2
API_HOST_LEAVES = 63
API_FIT_ROUNDS = 10
#: the learning rates of the reset_parameter schedule, one a tree
API_SCHEDULE = (0.1, 0.05, 0.025)
API_CONTRIB_ROWS = 2000
API_CONVERT_ROWS = 10_000
API_INGEST_POSTS = 8
API_INGEST_ROWS = 1024
API_PREDICT_THREADS = 4
API_PREDICT_ROWS = 64
#: each /predict thread's pause between requests: at 2 ms the threads
#: hold the GIL so often that the cycles' train and shadow steps take
#: 2.3-3x longer and phase 3k runs past its 90 s
API_PREDICT_PAUSE_S = 0.01
#: the windows of /predict traffic alone, before the first /ingest (the
#: forest kernel serves) and after the continue verdict
API_LATENCY_WINDOW_S = 2.0
API_CONTINUE_ROUNDS = 2
#: cv metric histories card vs host
API_CV_TOL = 1e-6
#: fold trees' leaf values card vs host, the CPU tests' tolerance
#: (tests/torch_port_cases.TRAIN_RTOL / TRAIN_ATOL): exp and the
#: histogram sums differ by an ulp
API_TREE_RTOL, API_TREE_ATOL = 1e-4, 1e-5
#: refit's leaf values card vs host, relative (the gradients differ by an
#: ulp of exp; the leaf sums run in f64 in another order)
API_REFIT_RTOL = 1e-5
#: pred_contrib row sums vs the raw scores (f64 SHAP against the card's
#: f32 forest sums)
API_CONTRIB_TOL = 1e-4
#: the compiled convert_model C++ vs the f64 host tree walk
API_CONVERT_TOL = 1e-10
#: a served answer vs one published version's prediction of its rows
API_ONLINE_TOL = 1e-6


def api_params(dev, leaves, extra=None):
    return dict(API_PARAMS, num_leaves=leaves, device_type=dev.type,
                **(extra or {}))


def fold_tree_diffs(a_models, b_models):
    """Where fold trees differ card vs host: for each tree whose structure
    (features, thresholds, decision types, children) differs, its first
    differing split with both sides' (feature, threshold, gain); for the
    others, leaf values past API_TREE_ATOL + API_TREE_RTOL |x|. Empty when
    the trees are equal."""
    import numpy as np
    out = []
    if len(a_models) != len(b_models):
        return ["%d trees against %d" % (len(a_models), len(b_models))]
    for i, (a, b) in enumerate(zip(a_models, b_models)):
        k = min(a.num_internal, b.num_internal)
        for r in range(k):
            if (a.split_feature[r], a.threshold[r], a.decision_type[r],
                    a.left_child[r], a.right_child[r]) != \
                    (b.split_feature[r], b.threshold[r], b.decision_type[r],
                     b.left_child[r], b.right_child[r]):
                out.append("tree %d split %d: card (%d, %.9g, gain %.9g) "
                           "host (%d, %.9g, gain %.9g)"
                           % (i, r, a.split_feature[r], a.threshold[r],
                              a.split_gain[r], b.split_feature[r],
                              b.threshold[r], b.split_gain[r]))
                break
        else:
            if a.num_leaves != b.num_leaves:
                out.append("tree %d: %d leaves against %d"
                           % (i, a.num_leaves, b.num_leaves))
            elif not np.allclose(b.leaf_value[:b.num_leaves],
                                 a.leaf_value[:a.num_leaves],
                                 rtol=API_TREE_RTOL, atol=API_TREE_ATOL):
                d = np.abs(b.leaf_value[:b.num_leaves]
                           - a.leaf_value[:a.num_leaves])
                out.append("tree %d: leaf values past %g + %g |x| (max "
                           "|diff| %.3g at %.3g)"
                           % (i, API_TREE_ATOL, API_TREE_RTOL, d.max(),
                              a.leaf_value[int(np.argmax(d))]))
    return out


def api_cv(dev, X, y, leaves, device_type):
    """``lgt.cv`` of (X, y): API_CV_FOLDS folds x API_CV_ROUNDS rounds,
    the fold boosters kept. Returns (result, wall s)."""
    import lightgbm_tpu_torch as lgt
    params = dict(api_params(dev, leaves, {"metric": ["auc",
                                                      "binary_logloss"]}),
                  device_type=device_type)
    t0 = time.perf_counter()
    res = lgt.cv(params, lgt.Dataset(X, label=y), API_CV_ROUNDS,
                 nfold=API_CV_FOLDS, seed=0, return_cvbooster=True)
    return res, time.perf_counter() - t0


def host_cv(X, y, leaves):
    """api_cv on the host, for host_call: {"folds": [(a fold booster's
    binned rows, its trees)], "hist": the histories, "seconds": the
    wall}."""
    import torch
    res, secs = api_cv(torch.device("cpu"), X, y, leaves, "cpu")
    folds = [(b.inner.train_set.binned, b.inner.models)
             for b in res.pop("cvbooster").boosters]
    return dict(folds=folds, hist=res, seconds=secs)


def api_compile_cpp(src, out_dir):
    """The convert_model source compiled with g++ into a ctypes library
    (PredictRaw)."""
    import ctypes
    import numpy as np
    so = os.path.join(out_dir, "model.so")
    r = subprocess.run(["g++", "-O1", "-shared", "-fPIC", "-std=c++14",
                        "-o", so, src], capture_output=True, text=True,
                       timeout=600)
    if r.returncode != 0:
        raise AssertionError("g++ failed on the converted model:\n%s"
                             % r.stderr[-2000:])
    lib = ctypes.CDLL(so)
    dptr = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
    lib.PredictRaw.argtypes = [dptr, dptr]
    lib.PredictRaw.restype = None
    return lib


def host_raw_f64(bst, X):
    """The host tree walk's f64 raw scores (one class)."""
    import numpy as np
    g = bst.inner
    score = np.zeros(len(X))
    for t in g.models:
        score += t.predict(X)
    return score + g.init_scores[0]


def api_serve_online(dev, bst, data, seed):
    """(g): ``bst`` behind a PredictServer with an online refit trainer
    (``start=True``: its worker thread trains), then a continue-mode
    trainer in its place, while API_PREDICT_THREADS threads post
    /predict and the main thread posts API_INGEST_POSTS labeled chunks
    to /ingest. Every answer must equal one published version's
    prediction of its rows. Each /predict's latency is kept by the part
    of the run it started in: ``idle`` (API_LATENCY_WINDOW_S of /predict
    alone before the first /ingest, after one warm-up request a thread), ``refit`` and ``continue`` (from
    the first /ingest of a cycle to its verdict) and ``after_continue``
    (API_LATENCY_WINDOW_S after the continue verdict). Returns (summary,
    {part: launch counts})."""
    import numpy as np
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.obs import telemetry
    from lightgbm_tpu_torch.online import OnlineTrainer
    from lightgbm_tpu_torch.ops import kernels
    from lightgbm_tpu_torch.serve import PredictServer, PredictSession

    rng = np.random.RandomState(seed + 71)
    X, y = data[2], data[3]
    chunk = API_INGEST_ROWS
    trigger = chunk * API_INGEST_POSTS // 2
    reqs = [higgs_like(rng, API_PREDICT_ROWS)
            for _ in range(API_PREDICT_THREADS)]
    versions = {bst.inner.model_version: bst.model_to_string()}
    refit = OnlineTrainer(bst, mode="refit", trigger_rows=trigger,
                          min_rows=64, shadow_rows=trigger)
    server = PredictServer(bst, port=0, buckets=(64, 256), max_wait_ms=1.0,
                           online=refit)
    base = "http://%s:%d" % server.address
    th = threading.Thread(target=server.serve_forever,
                          name="smoke-3k-http", daemon=True)
    th.start()
    stop = threading.Event()
    answers, failures = [], []
    parts = ("idle", "refit", "continue", "after_continue")
    window = [parts[0]]                 # the part a request starts in
    latency = {k: [] for k in parts}    # ms

    def post(path, obj):
        req = urllib.request.Request(base + path,
                                     data=json.dumps(obj).encode(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            return json.loads(resp.read())

    def predict_loop(i):
        while not stop.is_set():
            at = window[0]
            t = time.perf_counter()
            try:
                out = post("/predict", {"rows": reqs[i].tolist()})
                latency[at].append((time.perf_counter() - t) * 1e3)
                answers.append((i, out["model_version"],
                                np.asarray(out["predictions"])))
            except Exception as exc:        # every failure is counted
                failures.append(repr(exc))
            time.sleep(API_PREDICT_PAUSE_S)

    def wait_cycle(tr, trains, what):
        deadline = time.perf_counter() + 300
        while tr.state()["trains"] < trains \
                or tr.state()["last_result"] in ("idle", "skipped"):
            if time.perf_counter() > deadline:
                raise AssertionError("phase 3k (g): no %s cycle: %s"
                                     % (what, tr.state()))
            time.sleep(0.02)
        st = tr.state()
        if st["errors"]:
            raise AssertionError("phase 3k (g) %s: %s"
                                 % (what, st["last_error"]))
        versions[bst.inner.model_version] = bst.model_to_string()
        return st

    counts, states = {}, {}
    threads = [threading.Thread(target=predict_loop, args=(i,),
                                name="smoke-3k-predict-%d" % i)
               for i in range(API_PREDICT_THREADS)]
    try:
        sync(dev)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        for i in range(API_PREDICT_THREADS):        # warm the buckets
            out = post("/predict", {"rows": reqs[i].tolist()})
            answers.append((i, out["model_version"],
                            np.asarray(out["predictions"])))
        for t in threads:
            t.start()
        time.sleep(API_LATENCY_WINDOW_S)
        sync(dev)
        counts["idle"] = kernels.launch_counts()
        kernels.reset_launch_counts()
        window[0] = "refit"
        for p in range(API_INGEST_POSTS):
            if p == API_INGEST_POSTS // 2:
                states["refit"] = wait_cycle(refit, 1, "refit")
                sync(dev)
                counts["refit"] = kernels.launch_counts()
                kernels.reset_launch_counts()
                window[0] = "continue"
                # the continue cycle: a continue-mode trainer takes the
                # entry's place; its worker trains through the device
                # tree loop (a CUDA graph capture) beside the serving
                # threads
                entry = server.registry.get()
                entry.online = OnlineTrainer(
                    bst, mode="continue", trigger_rows=trigger, min_rows=64,
                    shadow_rows=trigger,
                    continue_rounds=API_CONTINUE_ROUNDS)
                refit.close()
            lo = p * chunk % (len(y) - chunk)
            out = post("/ingest", {"rows": X[lo:lo + chunk].tolist(),
                                   "labels": y[lo:lo + chunk].tolist()})
            if out.get("rows") != chunk:
                raise AssertionError("phase 3k (g): /ingest answered %s"
                                     % out)
        states["continue"] = wait_cycle(server.registry.get().online, 1,
                                        "continue")
        sync(dev)
        counts["continue"] = kernels.launch_counts()
        kernels.reset_launch_counts()
        window[0] = "after_continue"
        time.sleep(API_LATENCY_WINDOW_S)
        wall = time.perf_counter() - t0
        sync(dev)
        counts["after_continue"] = kernels.launch_counts()
        forest_after = bst.inner._forest_model(
            0, len(bst.inner.models) // bst.inner.num_tree_per_iteration) \
            is not None
        health = json.loads(urllib.request.urlopen(
            base + "/healthz", timeout=60).read())
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
        server.shutdown()
        th.join(timeout=60)
        server.close()
    if failures:
        raise AssertionError("phase 3k (g): %d failed requests, first %s"
                             % (len(failures), failures[0]))
    verdicts = sum(s["promotions"] + s["rejections"]
                   for s in states.values())
    if verdicts < 1:
        raise AssertionError("phase 3k (g): no gate verdict: %s" % states)
    # each published version's prediction of each thread's rows, through
    # the serving path (the serving train_set's bins where the forest
    # kernel is eligible)
    expected = {}
    for v, text in versions.items():
        b = lgt.Booster({"device_type": dev.type}, model_str=text)
        b.inner.train_set = bst.inner.train_set
        sess = PredictSession(b, buckets=(64, 256))
        expected[v] = [sess.predict(r) for r in reqs]
    worst = 0.0
    for i, v, out in answers:
        errs = [float(np.max(np.abs(out - expected[u][i])))
                for u in expected]
        worst = max(worst, min(errs))
        if min(errs) > API_ONLINE_TOL:
            raise AssertionError("phase 3k (g): an answer (version %d) "
                                 "equals no published version (closest "
                                 "%.3g)" % (v, min(errs)))
    lat = {k: dict(n=len(v), p50=float(np.percentile(v, 50)),
                   p99=float(np.percentile(v, 99)))
           for k, v in latency.items() if v}
    if set(lat) != set(parts):
        raise AssertionError("phase 3k (g): no /predict answer in parts %s"
                             % sorted(set(parts) - set(lat)))
    hists = telemetry.snapshot()["histograms"]
    summary = dict(
        predict_latency_ms=lat, forest_after_continue=forest_after,
        answers=len(answers), failures=0, versions=sorted(versions),
        served_versions=sorted({v for _, v, _ in answers}),
        max_abs_err=worst, wall_s=wall, verdicts=verdicts,
        refit=states["refit"]["last_result"],
        continue_=states["continue"]["last_result"],
        healthz_promotions=health["models"]["default"]["online"]
        ["promotions"],
        **{k: hists.get("online/" + k) for k in ("train_ms", "shadow_ms",
                                                 "promote_swap_ms")})
    log("phase 3k (g) online serving: %d answers from %d threads, 0 "
        "failures, versions %s (served %s), closest-version max |diff| "
        "%.3g; refit %s, continue %s; %.1f s; online/train_ms %s, "
        "online/shadow_ms %s, online/promote_swap_ms %s; launches refit "
        "part %s, continue part %s"
        % (len(answers), API_PREDICT_THREADS, summary["versions"],
           summary["served_versions"], worst, summary["refit"],
           summary["continue_"], wall, summary["train_ms"],
           summary["shadow_ms"], summary["promote_swap_ms"],
           nonzero(counts["refit"]), nonzero(counts["continue"])))
    log("phase 3k (g) /predict latency ms (%d rows a request, %d threads, "
        "%.0f ms pause): %s; after the continue verdict the model is %s; "
        "launches idle part %s, after-continue part %s"
        % (API_PREDICT_ROWS, API_PREDICT_THREADS, API_PREDICT_PAUSE_S * 1e3,
           "; ".join("%s n %d p50 %.3f p99 %.3f"
                     % (k, lat[k]["n"], lat[k]["p50"], lat[k]["p99"])
                     for k in parts),
           "on the forest kernel" if forest_after else
           "ineligible for the forest kernel (the raw walk serves it)",
           nonzero(counts["idle"]), nonzero(counts["after_continue"])))
    return summary, counts


def nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def phase_api_online(dev, data, card, leaves=255, host_rows=200_000,
                     seed=0, host_leaves=API_HOST_LEAVES,
                     fit_rounds=API_FIT_ROUNDS):
    """Phase 3k, the API surface and online training at full width:
    (a) cv on the card (wall a fold, mean valid AUC), and (last, after
    the online part's worker thread has launched the same kernels) card
    against host at ``host_rows`` rows and ``host_leaves`` leaves: equal
    folds, equal fold trees (API_TREE_RTOL / API_TREE_ATOL), histories
    within API_CV_TOL; (b) LGBMClassifier,
    ``fit_rounds`` fused rounds: predict_proba equal to Booster.predict,
    feature_importances_ to the booster's; (c) the reset_parameter
    schedule: each tree's shrinkage equals it; (d) refit of (b)'s model on
    the valid rows, card against host within API_REFIT_RTOL, its sha256;
    (e) pred_contrib: row sums equal the raw scores within
    API_CONTRIB_TOL, host ms; (f) convert_model through the command line,
    compiled with g++, equal to the f64 raw scores within
    API_CONVERT_TOL; (g) api_serve_online. Launch counts are zeroed
    before each part and read after. Returns (summary, {part: counts})."""
    import hashlib
    import numpy as np
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import cli
    from lightgbm_tpu_torch.ops import kernels

    t_start = time.perf_counter()
    X, y, Xv, yv = data
    summary, counts = {}, {}

    def part(name):
        sync(dev)
        counts[name] = kernels.launch_counts()
        kernels.reset_launch_counts()

    sync(dev)
    kernels.reset_launch_counts()
    # (a) cv at full size on the card
    res, wall = api_cv(dev, X, y, leaves, dev.type)
    part("cv")
    for b in res["cvbooster"].boosters:
        if b.inner.device.type != dev.type:
            raise AssertionError("phase 3k (a): a fold trained on %s"
                                 % b.inner.device)
    auc = res["valid auc-mean"][-1]
    if not 0.5 < auc <= 1.0:
        raise AssertionError("phase 3k (a): mean valid auc %.4f" % auc)
    summary["cv"] = dict(rows=len(y), folds=API_CV_FOLDS,
                         rounds=API_CV_ROUNDS, leaves=leaves, wall_s=wall,
                         wall_per_fold_s=wall / API_CV_FOLDS,
                         valid_auc_mean=auc,
                         valid_auc_stdv=res["valid auc-stdv"][-1])
    log("phase 3k (a) cv: %d rows, %d folds x %d rounds x %d leaves in "
        "%.1f s (%.1f s a fold); mean valid auc %.5f (stdv %.5f); "
        "launches %s" % (len(y), API_CV_FOLDS, API_CV_ROUNDS, leaves, wall,
                         wall / API_CV_FOLDS, auc,
                         res["valid auc-stdv"][-1], nonzero(counts["cv"])))
    del res
    Xh, yh = X[:host_rows], y[:host_rows]


    # (b) the scikit-learn classifier, fused rounds
    clf = lgt.LGBMClassifier(n_estimators=fit_rounds, num_leaves=leaves,
                             max_bin=255, device_type=dev.type,
                             verbosity=-1)
    t0 = time.perf_counter()
    clf.fit(X, y)
    sync(dev)
    t_fit = time.perf_counter() - t0
    part("sklearn_fit")
    bst = clf.booster_
    t0 = time.perf_counter()
    proba = clf.predict_proba(Xv)
    t_proba = time.perf_counter() - t0
    part("sklearn_predict")
    if not (np.array_equal(proba[:, 1], bst.predict(Xv))
            and np.array_equal(clf.feature_importances_,
                               bst.feature_importance("split"))
            and list(clf.classes_) == [0.0, 1.0]):
        raise AssertionError("phase 3k (b): predict_proba, "
                             "feature_importances_ or classes_ differ from "
                             "the booster's")
    fit_auc = auc_np(yv, proba[:, 1])
    summary["sklearn"] = dict(rows=len(y), rounds=fit_rounds, fit_s=t_fit,
                              predict_proba_s=t_proba, valid_auc=fit_auc)
    log("phase 3k (b) LGBMClassifier: %d fused rounds on %d rows in %.2f "
        "s, predict_proba of %d rows in %.3f s, valid auc %.5f; launches "
        "fit %s, predict %s" % (fit_rounds, len(y), t_fit, len(yv), t_proba,
                                fit_auc, nonzero(counts["sklearn_fit"]),
                                nonzero(counts["sklearn_predict"])))

    # (c) the reset_parameter schedule
    params = api_params(dev, leaves)
    sched = list(API_SCHEDULE)
    sbst = lgt.train(params, lgt.Dataset(Xh, label=yh, params=params),
                     len(sched),
                     callbacks=[lgt.reset_parameter(learning_rate=sched)])
    part("reset_parameter")
    got = [t.shrinkage for t in sbst.inner.models]
    if got != sched:
        raise AssertionError("phase 3k (c): shrinkages %s, schedule %s"
                             % (got, sched))
    summary["reset_parameter"] = dict(rows=host_rows, shrinkage=got)
    log("phase 3k (c) reset_parameter: %d trees on %d rows, shrinkages %s "
        "= the schedule; launches %s" % (len(sched), host_rows, got,
                                         nonzero(counts["reset_parameter"])))
    del sbst

    # (d) refit on the valid rows, card against host
    text = bst.model_to_string()
    t0 = time.perf_counter()
    ref_card = bst.refit(Xv, yv)
    t_refit = time.perf_counter() - t0
    part("refit")
    t0 = time.perf_counter()
    ref_host = lgt.Booster({"device_type": "cpu"}, model_str=text).refit(
        Xv, yv)
    t_refit_host = time.perf_counter() - t0
    if ref_card.inner.device.type != dev.type:
        raise AssertionError("phase 3k (d): refit built its booster on %s"
                             % ref_card.inner.device)
    worst = 0.0
    for a, b in zip(ref_card.inner.models, ref_host.inner.models):
        lv_a, lv_b = a.leaf_value[:a.num_leaves], b.leaf_value[:b.num_leaves]
        worst = max(worst, float(np.max(np.abs(lv_a - lv_b)
                                        / np.maximum(np.abs(lv_b), 1e-12))))
        if not np.allclose(lv_a, lv_b, rtol=API_REFIT_RTOL, atol=0):
            raise AssertionError("phase 3k (d): refit leaves card vs host "
                                 "past %g relative" % API_REFIT_RTOL)
    sha = hashlib.sha256(ref_card.model_to_string().encode()).hexdigest()
    summary["refit"] = dict(rows=len(yv), card_s=t_refit,
                            host_s=t_refit_host, max_rel_diff=worst,
                            model_sha256=sha)
    log("phase 3k (d) refit: %d rows, card %.3f s, host %.3f s, leaves "
        "card vs host max relative |diff| %.3g (limit %.0e); sha256 %s; "
        "launches %s" % (len(yv), t_refit, t_refit_host, worst,
                         API_REFIT_RTOL, sha, nonzero(counts["refit"])))
    del ref_card, ref_host

    # (e) pred_contrib
    Xc = Xv[:API_CONTRIB_ROWS]
    t0 = time.perf_counter()
    contrib = bst.predict(Xc, pred_contrib=True)
    t_contrib = (time.perf_counter() - t0) * 1e3
    raw = bst.predict(Xc, raw_score=True)
    part("pred_contrib")
    err = float(np.max(np.abs(contrib.sum(axis=1) - raw)))
    if contrib.shape != (len(Xc), HIGGS_FEATURES + 1) \
            or not err <= API_CONTRIB_TOL:
        raise AssertionError("phase 3k (e): contributions %s, row sums vs "
                             "raw %.3g" % (contrib.shape, err))
    summary["pred_contrib"] = dict(rows=len(Xc), host_ms=t_contrib,
                                   max_abs_err=err)
    log("phase 3k (e) pred_contrib: %d rows x %d trees in %.1f host ms, "
        "row sums vs raw scores max |diff| %.3g (limit %.0e)"
        % (len(Xc), len(bst.inner.models), t_contrib, err, API_CONTRIB_TOL))

    # (f) convert_model through the command line, compiled
    with tempfile.TemporaryDirectory() as tmp:
        model = os.path.join(tmp, "model.txt")
        src = os.path.join(tmp, "model.cpp")
        bst.save_model(model)
        t0 = time.perf_counter()
        cli.main(["task=convert_model", "input_model=%s" % model,
                  "convert_model=%s" % src, "device_type=%s" % dev.type,
                  "verbosity=-1"])
        t_convert = time.perf_counter() - t0
        t0 = time.perf_counter()
        lib = api_compile_cpp(src, tmp)
        t_gxx = time.perf_counter() - t0
        Xf = np.ascontiguousarray(Xv[:API_CONVERT_ROWS], np.float64)
        got = np.zeros(len(Xf))
        out = np.zeros(1)
        for i, row in enumerate(Xf):
            lib.PredictRaw(row, out)
            got[i] = out[0]
    part("convert_model")
    err = float(np.max(np.abs(got - host_raw_f64(bst, Xf))))
    if not err <= API_CONVERT_TOL:
        raise AssertionError("phase 3k (f): compiled model vs raw scores "
                             "%.3g" % err)
    summary["convert_model"] = dict(rows=len(Xf), convert_s=t_convert,
                                    gxx_s=t_gxx, max_abs_err=err)
    log("phase 3k (f) convert_model: C++ written in %.2f s, g++ %.1f s; "
        "%d rows vs the f64 raw scores max |diff| %.3g (limit %.0e)"
        % (t_convert, t_gxx, len(Xf), err, API_CONVERT_TOL))

    # (g) online training behind /ingest
    summary["online"], online_counts = api_serve_online(dev, bst, data,
                                                        seed)
    for k, v in online_counts.items():
        counts["online_" + k] = v
    sync(dev)
    kernels.reset_launch_counts()
    # (a) cv card vs host at host_rows rows
    cv_card, t_card = api_cv(dev, Xh, yh, host_leaves, dev.type)
    part("cv_card_vs_host")
    card_folds = [(b.inner.train_set.binned, b.inner.models)
                  for b in cv_card.pop("cvbooster").boosters]
    out = summary["cv"]["card_vs_host"] = dict(
        rows=host_rows, leaves=host_leaves, card_s=t_card)

    def check_cv(host):
        diffs = []
        for i, ((a_bins, a_trees), (b_bins, b_trees)) in enumerate(
                zip(card_folds, host["folds"])):
            # the same rows in the same order, binned alike
            if not np.array_equal(a_bins, b_bins):
                raise AssertionError("phase 3k (a): fold %d's rows differ "
                                     "card vs host" % i)
            diffs += ["fold %d %s" % (i, d)
                      for d in fold_tree_diffs(a_trees, b_trees)]
        diff = max(float(np.max(np.abs(np.subtract(cv_card[k],
                                                   host["hist"][k]))))
                   for k in cv_card)
        log("phase 3k (a) cv card vs host: %d rows x %d leaves, folds "
            "equal, fold trees %s, histories max |diff| %.3g (limit %.0e); "
            "card %.1f s, host %.1f s"
            % (host_rows, host_leaves, "; ".join(diffs) or "equal", diff,
               API_CV_TOL, t_card, host["seconds"]))
        out.update(max_abs_diff=diff, host_s=host["seconds"],
                   tree_diffs=diffs)
        if diffs or diff > API_CV_TOL:
            raise AssertionError("phase 3k (a): cv card vs host: trees %s, "
                                 "histories differ by %.3g" % (diffs, diff))

    host_call(host_cv, (Xh, yh, host_leaves), check_cv)
    summary["wall_s"] = time.perf_counter() - t_start
    log("phase 3k took %.1f s (%s)" % (summary["wall_s"], card))
    return summary, counts



# -------------------------------------------------------------- fleet phase

#: the raw-threshold walk's edge packs (raw_edge_pack) and their row counts
RAW_EDGE_CASES = ("numerical", "zero_missing", "nan_missing",
                  "mixed_missing", "categorical", "multiclass3",
                  "linear_nan", "chain254", "deep", "no_splits",
                  "padded_rounds", "padded_trees", "wide")
RAW_EDGE_ROWS = (1, 255, 257, 4097)
#: the wide pack's columns: a pass's rows no longer fit beside the tables,
#: so its walks read the rows from device memory
RAW_WIDE_F = 1000
#: phase 3l (a): the HIGGS-shaped model's trees (the script's --trees), the
#: row counts the raw walk is held to its twin at, and the rows a model of
#: another kind (categorical, multiclass, linear) is checked on
RAW_ROWS = (1, 64, 4096, 65536)
RAW_KIND_ROWS = 4096
#: phase 3l (b): the fleet's traffic: /predict threads (half on each
#: replica), rows a request, the pause between requests, labeled chunks to
#: the trainer's /ingest (one of them through a replica, forwarded), and
#: the windows of /predict traffic before the first /ingest and after both
#: replicas adopted the promotion
FLEET_PREDICT_THREADS = 4
FLEET_PREDICT_ROWS = 64
FLEET_PREDICT_PAUSE_S = 0.01
FLEET_INGEST_POSTS = 8
FLEET_INGEST_ROWS = 1024
FLEET_LATENCY_WINDOW_S = 2.0
FLEET_CONTINUE_ROUNDS = 2
#: the replicas' poll interval and the serving trainer's lease ttl; the
#: failover drill's ttl (c), within two of which the standby must take over
FLEET_POLL_S = 0.1
FLEET_SERVE_TTL_S = 5.0
FLEET_TTL_S = 1.0
#: the failover drill's labeled chunks (c, d)
FLEET_DRILL_ROWS = 512
#: the gate threshold of the fleet's trainers: wide open, so the continue
#: cycle promotes (the phase tests distribution, not the gate's judgment)
FLEET_PROMOTE_THRESHOLD = 2.0


def raw_edge_pack(name, rng, n, dev, F=7):
    """A seeded PackedSplits that stresses one edge of the raw-threshold
    walk, with (n, F) f32 raw rows. Returns (pack, X, predict kwargs). The
    rows mix values equal to a threshold (the <= edge), values between
    them, +0 and -0, the Zero missing type's 1e-35 edge and its
    neighbours, NaN and +-inf. Cases: one missing type for every round
    (none, Zero, NaN) or a mix; categorical rounds on three columns of
    integers, -1, non-integers, NaN and +-inf; 3 classes over 40 trees;
    linear leaves with NaN raw values; a 254-round chain (round r splits
    slot r; rows go right but at every 32nd round) and a deep one, one
    round past FOREST_MAX_ROUNDS (the walk reads its tables from device
    memory); num_splits 0 (half the trees); padded rounds (num_splits
    below R, junk after); 11 trees (the walk pads them to 16); RAW_WIDE_F
    columns at 254 rounds."""
    import numpy as np
    import torch
    from lightgbm_tpu_torch.ops.predict import PackedSplits

    from lightgbm_tpu_torch.ops.forest import FOREST_MAX_ROUNDS

    T, R, K, Km, Kc = 16, 62, 1, 1, 1
    if name in ("chain254", "wide"):
        R = 254
    if name == "deep":
        R = FOREST_MAX_ROUNDS + 1
    if name == "wide":
        F = RAW_WIDE_F
    if name == "multiclass3":
        T, K = 40, 3
    if name == "padded_trees":
        T = 11
    if name == "linear_nan":
        Km = 3
    if name == "categorical":
        Kc = 6
    L = R + 1
    slot = np.array([[rng.randint(0, r + 1) for r in range(R)]
                     for _ in range(T)], np.int32)
    feature = rng.randint(0, F, (T, R)).astype(np.int64)
    grid = (np.round(rng.normal(0.0, 1.0, 64) * 64) / 64).astype(np.float32)
    threshold = rng.choice(grid, (T, R)).astype(np.float32)
    kind = np.zeros((T, R), np.int32)
    default_left = rng.rand(T, R) < 0.5
    missing_type = np.zeros((T, R), np.int32)
    ns = np.full(T, R, np.int32)
    cat_values = np.full((T, R, Kc), -2, np.int32)
    X = rng.choice(grid, (n, F)).astype(np.float32)
    between = rng.rand(n, F) < 0.3
    X[between] = rng.normal(0.0, 1.0, int(between.sum()))
    k0 = np.float32(1e-35)
    up, down = np.nextafter(k0, np.float32(1)), np.nextafter(k0, np.float32(0))
    edges = np.array([0.0, -0.0, k0, -k0, up, -up, down, -down, np.nan,
                      np.inf, -np.inf], np.float32)
    at_edge = rng.rand(n, F) < 0.25
    X[at_edge] = rng.choice(edges, int(at_edge.sum()))
    if name == "zero_missing":
        missing_type[:] = 1
    elif name == "nan_missing":
        missing_type[:] = 2
    elif name in ("mixed_missing", "multiclass3", "linear_nan", "wide"):
        missing_type[:] = rng.randint(0, 3, (T, R))
    elif name in ("chain254", "deep"):
        slot[:] = np.arange(R)
        threshold[:] = np.where(np.arange(R) % 32 == 31, 0.0, -1e30)
    elif name == "no_splits":
        ns[::2] = 0
    elif name == "padded_rounds":
        ns[:] = rng.randint(1, R, T)
        pad = np.arange(R)[None, :] >= ns[:, None]
        slot[pad], feature[pad], threshold[pad] = 0, 1, 1e30
    elif name == "categorical":
        missing_type[:] = rng.randint(0, 3, (T, R))
        kind[:] = rng.rand(T, R) < 0.3
        feature[kind == 1] = rng.randint(0, 3, int(kind.sum()))
        for t, r in zip(*np.nonzero(kind)):
            k = rng.randint(0, Kc + 1)
            cat_values[t, r, :k] = rng.choice(8, k, replace=False)
        cats = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, -1, 2.5, -0.5, 7.99,
                         np.nan, np.inf, -np.inf], np.float32)
        X[:, :3] = rng.choice(cats, (n, 3))
    value = rng.normal(0.0, 0.05, (T, L)).astype(np.float32)
    const = np.zeros((T, L), np.float32)
    coeff = np.zeros((T, L, Km), np.float32)
    coeff_feat = np.zeros((T, L, Km), np.int64)
    coeff_mask = np.zeros((T, L, Km), bool)
    if name == "linear_nan":
        const[:] = rng.normal(0.0, 0.05, (T, L))
        coeff[:] = rng.normal(0.0, 0.05, (T, L, Km))
        coeff_feat[:] = rng.randint(0, F, (T, L, Km))
        coeff_mask[:] = rng.rand(T, L, Km) < 0.7
        X[~np.isfinite(X) & ~np.isnan(X)] = 0.0   # +-inf: no linear output

    def dev_t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=dev,
                                                            dtype=dtype)

    pk = PackedSplits(
        slot=dev_t(slot, torch.int32), feature=dev_t(feature, torch.int64),
        threshold=dev_t(threshold, torch.float32),
        kind=dev_t(kind, torch.int32),
        default_left=dev_t(default_left, torch.bool),
        missing_type=dev_t(missing_type, torch.int32),
        num_splits=dev_t(ns, torch.int32),
        value_of_slot=dev_t(value, torch.float32),
        tree_class=dev_t(np.arange(T) % K, torch.int32),
        cat_values=dev_t(cat_values, torch.int32),
        const_of_slot=dev_t(const, torch.float32),
        coeff=dev_t(coeff, torch.float32),
        coeff_feat=dev_t(coeff_feat, torch.int64),
        coeff_mask=dev_t(coeff_mask, torch.bool))
    kw = dict(num_class=K, has_cat=name == "categorical",
              has_linear=name == "linear_nan")
    return pk, torch.from_numpy(X).to(dev), kw


def phase_raw_kernels(dev, rng):
    """The raw-threshold walk against its twin (``predict_raw_impl``) on
    every RAW_EDGE_CASES pack at RAW_EDGE_ROWS rows (each launch with the
    pack's raw_walk): bit-equal without linear leaves, else within
    SCORE_ATOL + SCORE_RTOL * |b|. Only the wide pack's plan reads the
    rows from device memory, only the deep pack's its tables. On the host
    both sides are the twin (a rehearsal of the phase)."""
    from lightgbm_tpu_torch.ops.forest import forest_plan, raw_walk
    from lightgbm_tpu_torch.ops.predict import predict_raw, predict_raw_impl
    errs = {}
    for name in RAW_EDGE_CASES:
        pk, X, kw = raw_edge_pack(name, rng, max(RAW_EDGE_ROWS), dev)
        rw = raw_walk(pk)
        R, T, _ = rw.nodes.shape
        plan = forest_plan(1, T, R, 1, X.shape[1], kw["num_class"],
                           raw=True)
        if plan.staged == (name == "wide") \
                or plan.tables == (name == "deep"):
            raise AssertionError("raw_edge/%s: plan %s" % (name, plan))
        for n in RAW_EDGE_ROWS:
            got = predict_raw(X[:n], pk, walk=rw, **kw)
            want = predict_raw_impl(X[:n], pk, **kw)
            sync(dev)
            key = "raw_edge/%s/%d" % (name, n)
            errs[key] = (check_scores if kw["has_linear"] else check_bits)(
                key, got.cpu().numpy(), want.cpu().numpy())
    return errs


def raw_walk_steps(trees, pack, X, has_cat):
    """Links the raw walk follows for the rows ``X`` through ``trees``
    (packed as ``pack``): the depth of each row's leaf, summed over rows
    and trees."""
    import torch
    from lightgbm_tpu_torch.ops.predict import _route_trees

    slots = _route_trees(X.to(torch.float32), pack, has_cat).long()
    steps = 0
    for t, tree in enumerate(trees):
        leaf_of_slot = tree.to_split_arrays()["leaf_of_slot"]
        depth = torch.as_tensor(tree.leaf_depths()[leaf_of_slot])
        steps += int(depth.to(X.device)[slots[t]].sum())
    return steps


def raw_bound(pack, walk, X, steps, num_class=1, has_cat=False,
              has_linear=False):
    """(bytes, operations) one raw walk call must move and do: the (n, F)
    f32 rows read once, the tables it reads for this pack (walk entries,
    first rounds, leaf values and classes; the category sets and linear
    tables only where used) read once, the (n, K) f32 scores written once;
    two operations a walk step and one a (row, tree)."""
    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    n = X.shape[0]
    b = nbytes(X, walk.nodes, walk.first, walk.value_of_slot,
               walk.tree_class) + n * max(1, num_class) * 4
    if has_cat:
        b += nbytes(walk.cat_values)
    if has_linear:
        b += nbytes(walk.const_of_slot, walk.coeff, walk.coeff_feat,
                    walk.coeff_mask)
    return b, 2 * steps + walk.nodes.shape[1] * n


def fleet_kind_models(dev, seed, rows=(MIXED_ROWS, OBJECTIVE_ROWS,
                                        LINEAR_HOST_ROWS)):
    """Models of the kinds the HIGGS model lacks, each read back from its
    text (no bin mappers: the raw walk serves it): phase 3e's categorical
    and EFB model (MIXED_ROWS rows, MIXED_TREES trees, 63 leaves), a 3g
    multiclass model (3 classes, OBJECTIVE_ROWS rows, OBJECTIVE_TREES
    iterations, OBJECTIVE_LEAVES leaves) and a 3j linear model
    (LINEAR_HOST_ROWS rows, LINEAR_HOST_TREES trees, LINEAR_HOST_LEAVES
    leaves); ``rows`` cuts the three row counts. Returns {name: (booster,
    rows)}."""
    import numpy as np
    import lightgbm_tpu_torch as lgt

    out = {}
    X, y, cats = mixed_data(seed, rows[0])
    bst = lgt.train(dict(MIXED_PARAMS, device_type=dev.type),
                    lgt.Dataset(X, label=y, categorical_feature=cats),
                    MIXED_TREES)
    out["categorical"] = (bst, X)
    rng = np.random.RandomState(seed + 83)
    X = higgs_like(rng, rows[1])
    y = objective_labels("multiclassova", X, rng)
    bst = lgt.train({"objective": "multiclass", "num_class": 3,
                     "num_leaves": OBJECTIVE_LEAVES, "max_bin": 255,
                     "verbosity": -1, "device_type": dev.type},
                    lgt.Dataset(X, label=y), OBJECTIVE_TREES)
    out["multiclass"] = (bst, X)
    X = higgs_like(rng, rows[2])
    y = np.round((higgs_signal(X) + 0.5 * rng.randn(len(X))) * 1024) / 1024
    bst = lgt.train({"objective": "regression", "linear_tree": True,
                     "linear_lambda": LINEAR_LAMBDA,
                     "num_leaves": LINEAR_HOST_LEAVES, "max_bin": 255,
                     "verbosity": -1, "device_type": dev.type},
                    lgt.Dataset(X, label=y), LINEAR_HOST_TREES)
    out["linear"] = (bst, X)
    return {k: (lgt.Booster({"device_type": dev.type},
                            model_str=b.model_to_string()), rows)
            for k, (b, rows) in out.items()}


def fleet_raw_checks(dev, bst, X, seed, errs, timed=True, kind_rows=None):
    """(a): the raw walk against its twin on the card, on the models the
    fleet serves: ``bst`` read back from its text at RAW_ROWS rows of
    ``X`` (bit-equal), and fleet_kind_models at RAW_KIND_ROWS rows
    (bit-equal but the linear model's, within SCORE_ATOL + SCORE_RTOL |b|,
    B8's tolerance). Then, when ``timed``, the top size by the host clock
    and by device time beside its bound and the twin's time. Returns the
    kernels-line row (with ``bytes`` and ``ops``; None untimed) and the
    per-size figures."""
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops.forest import raw_walk
    from lightgbm_tpu_torch.ops.predict import predict_raw, predict_raw_impl

    models = {"higgs": (lgt.Booster({"device_type": dev.type},
                                    model_str=bst.model_to_string()), X)}
    models.update(fleet_kind_models(dev, seed, **(
        {"rows": kind_rows} if kind_rows else {})))
    shapes = {}
    for name, (b, rows) in models.items():
        g = b.inner
        if g.train_set is not None:
            raise AssertionError("phase 3l: the %s model has bin mappers"
                                 % name)
        pk, has_cat, has_lin, walk = g._packed_model(
            0, len(g.models) // g.num_tree_per_iteration)
        if walk is None:          # a rehearsal on the host keeps none
            walk = raw_walk(pk)
        kw = dict(num_class=g.num_tree_per_iteration, has_cat=has_cat,
                  has_linear=has_lin)
        for n in (RAW_ROWS if name == "higgs" else (RAW_KIND_ROWS,)):
            x = torch.as_tensor(rows[:n], dtype=torch.float32).to(dev)
            n = x.shape[0]
            got = predict_raw(x, pk, walk=walk, **kw)
            want = predict_raw_impl(x, pk, **kw)
            sync(dev)
            key = "raw/%s/%d" % (name, n)
            errs[key] = (check_scores if has_lin else check_bits)(
                key, got.cpu().numpy(), want.cpu().numpy())
            steps = raw_walk_steps(g.models, pk, x, has_cat)
            nbytes, ops = raw_bound(pk, walk, x, steps, **kw)
            v = dict(rows=n, trees=len(g.models), steps=steps,
                     bytes=nbytes, ops=ops)
            if timed and name == "higgs":
                def fn():
                    return predict_raw(x, pk, walk=walk, **kw)
                t_b = nbytes / PEAK_BYTES_PER_S * 1e3
                t_o = ops / PEAK_SCALAR_OPS_PER_S * 1e3
                v.update(ms=cuda_ms(fn), device_ms=device_ms(fn),
                         bound_ms=max(t_b, t_o),
                         bound_by="bytes" if t_b >= t_o else "operations")
                log("raw walk %s: %d rows x %d trees, %d walk steps: %.4f "
                    "ms (device %.4f), bound %.5f ms (%s)"
                    % (name, n, len(g.models), steps, v["ms"],
                       v["device_ms"], v["bound_ms"], v["bound_by"]))
            shapes["%s_%d" % (name, n)] = v
    row = None
    if timed:
        g = models["higgs"][0].inner
        pk, _, _, walk = g._packed_model(0, len(g.models))
        x = torch.as_tensor(X[:max(RAW_ROWS)], dtype=torch.float32).to(dev)
        top = shapes["higgs_%d" % max(RAW_ROWS)]
        row = dict(
            route="cuda", source="lightgbm_tpu_torch/csrc/forest_predict.cu",
            replaces="lightgbm_tpu/ops/predict.py:145 (predict_raw_impl, "
            "XLA: the _route_tree fori_loop and the grouped sums; no "
            "pallas_call)",
            max_abs_err=max(v for k, v in errs.items()
                            if k.startswith("raw")),
            ms=top["ms"], device_ms=top["device_ms"],
            plain_ms=cuda_ms(lambda: predict_raw_impl(x, pk), iters=3,
                             warmup=1),
            bytes=top["bytes"], ops=top["ops"], shapes=shapes)
    return row, shapes


def free_port():
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_json(url, obj=None, timeout=120):
    """GET (POST when ``obj`` is given) ``url``; the decoded JSON answer."""
    data = None if obj is None else json.dumps(obj).encode()
    req = urllib.request.Request(url, data=data,
                                 method="GET" if obj is None else "POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def wait_until(pred, what, timeout_s, every_s=0.05):
    """Poll ``pred()`` until it is true; raises after ``timeout_s``."""
    deadline = time.perf_counter() + timeout_s
    while True:
        got = pred()
        if got:
            return got
        if time.perf_counter() > deadline:
            raise AssertionError("phase 3l: timed out waiting for %s" % what)
        time.sleep(every_s)


def start_replica_process(dev, trainer_url, work):
    """``python -m lightgbm_tpu_torch task=serve fleet_role=replica
    fleet_url=<trainer>`` on a free port, its output in ``work``. Returns
    (process, base url, log path)."""
    port = free_port()
    logp = os.path.join(work, "replica.log")
    env = dict(os.environ, PYTHONPATH=HERE)
    with open(logp, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "lightgbm_tpu_torch", "task=serve",
             "fleet_role=replica", "fleet_url=" + trainer_url,
             "serve_host=127.0.0.1", "serve_port=%d" % port,
             "serve_buckets=%d,%d" % (FLEET_PREDICT_ROWS, 256),
             "serve_max_wait_ms=1", "fleet_poll_interval_s=%g"
             % FLEET_POLL_S, "device_type=" + dev.type, "verbosity=-1"],
            cwd=work, env=env, stdout=out, stderr=subprocess.STDOUT)
    return proc, "http://127.0.0.1:%d" % port, logp


def stop_process(proc, timeout_s=60):
    """SIGTERM (the server drains), then SIGKILL past ``timeout_s``."""
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=timeout_s)
    return proc.returncode


def fleet_serving(dev, bst, data, seed, work):
    """(b): a shared-directory fleet on the card. The trainer: ``bst``
    behind a PredictServer with a continue-mode OnlineTrainer over a
    FleetStore (seeded by a ``boot`` publish, leased, its serving URL
    advertised). The replicas: a ReplicaWatcher over the same directory
    in this process (with an IngestForwarder), and a ``python -m
    lightgbm_tpu_torch task=serve fleet_role=replica fleet_url=<trainer>``
    subprocess over RemoteStore. FLEET_PREDICT_THREADS threads post
    /predict to the replicas (half each) while FLEET_INGEST_POSTS labeled
    chunks go to the trainer's /ingest, one of them through the
    in-process replica (forwarded). Every answer must equal one published
    version's scores (|diff| 0 against the plain twin on that version's
    text, on the host), each replica must move up one version per
    publish, and each replica's dispatches in the window must each have
    launched the raw walk (the in-process replica's tallied on its
    dispatching threads, the process's from its /healthz before and
    after the window), while no call on the card in this process (the
    trainer and the in-process replica) reaches the twin. Returns
    (summary, launch counts of this process over the run)."""
    import numpy as np
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.fleet import (FleetStore, IngestForwarder,
                                          ReplicaWatcher, bootstrap_model)
    from lightgbm_tpu_torch.online import OnlineTrainer
    from lightgbm_tpu_torch.ops import kernels
    from lightgbm_tpu_torch.ops import predict as predict_ops
    from lightgbm_tpu_torch.serve import PredictServer, PredictSession

    rng = np.random.RandomState(seed + 97)
    X, y = data[2], data[3]
    chunk = FLEET_INGEST_ROWS
    trigger = chunk * FLEET_INGEST_POSTS
    reqs = [higgs_like(rng, FLEET_PREDICT_ROWS)
            for _ in range(FLEET_PREDICT_THREADS)]
    root = os.path.join(work, "serving")
    store = FleetStore(root, "default")
    store.publish(bst.model_to_string(), event="boot")
    trainer = OnlineTrainer(bst, mode="continue", trigger_rows=trigger,
                            min_rows=64, shadow_rows=trigger,
                            continue_rounds=FLEET_CONTINUE_ROUNDS,
                            promote_threshold=FLEET_PROMOTE_THRESHOLD,
                            store=store, lease_ttl_s=FLEET_SERVE_TTL_S,
                            holder_id="trainer")
    servers, threads, procs = [], [], []
    stop = threading.Event()
    answers, failures = [], []
    parts = ("before", "cycle", "after")
    window = [parts[0]]
    latency = {k: [] for k in parts}
    # every call of the plain twin with a tensor on the card (none may be;
    # this process's nodes: the trainer and the in-process replica)
    plain_calls = []
    twin = predict_ops.predict_raw_impl
    # the in-process replica's dispatches in the window and the launches
    # they made, tallied on the thread that dispatches (the per-thread
    # tally of ops/kernels.capture_launches, then counted as run)
    replica_tally = {"on": False, "dispatches": 0, "launches": {}}
    tally_lock = threading.Lock()

    def counted_twin(X_, *a, **k):
        if X_.device.type != "cpu":
            plain_calls.append(tuple(X_.shape))
        return twin(X_, *a, **k)

    def serve(server, name):
        th = threading.Thread(target=server.serve_forever, name=name,
                              daemon=True)
        th.start()
        servers.append((server, th))
        return "http://%s:%d" % server.address

    def predict_loop(i, base):
        while not stop.is_set():
            at = window[0]
            t = time.perf_counter()
            try:
                out = http_json(base + "/predict",
                                {"rows": reqs[i].tolist()})
                latency[at].append((time.perf_counter() - t) * 1e3)
                answers.append((i, base, out["model_version"],
                                np.asarray(out["predictions"])))
            except Exception as exc:       # every failure is counted
                failures.append(repr(exc))
            time.sleep(FLEET_PREDICT_PAUSE_S)

    predict_ops.predict_raw_impl = counted_twin
    try:
        server_t = PredictServer(bst, port=0, buckets=(FLEET_PREDICT_ROWS,
                                                       256),
                                 max_wait_ms=1.0, online=trainer)
        server_t.fleet_store = store
        base_t = serve(server_t, "smoke-3l-trainer")
        trainer.advertise_url = base_t
        if not trainer.wait_for_lease(10 * FLEET_SERVE_TTL_S):
            raise AssertionError("phase 3l (b): the trainer never took "
                                 "the lease: %s" % store.lease_state())
        # the lease record carries the URL from the next renewal on
        wait_until(lambda: store.lease_state().get("url") == base_t,
                   "the trainer's advertised url", 4 * FLEET_SERVE_TTL_S)
        rstore = FleetStore(root, "default", read_only=True)
        rb, applied = bootstrap_model(rstore, {"device_type": dev.type})
        if rb is None or applied != 1:
            raise AssertionError("phase 3l (b): replica bootstrap got v%d"
                                 % applied)
        server_r = PredictServer(rb, port=0, buckets=(FLEET_PREDICT_ROWS,
                                                      256),
                                 max_wait_ms=1.0)
        server_r.fleet_watcher = ReplicaWatcher(
            rb, rstore, poll_interval_s=FLEET_POLL_S,
            applied_version=applied, node_id="replica-in-process")
        server_r.ingest_forwarder = IngestForwarder(store=rstore)
        session_r = server_r.session
        dispatch_r = session_r.dispatch

        def tallied_dispatch(X_):
            with kernels.capture_launches() as cap:
                pieces = dispatch_r(X_)
            kernels.add_launches(cap.counts)
            with tally_lock:
                if replica_tally["on"]:
                    replica_tally["dispatches"] += 1
                    for k, v in cap.counts.items():
                        replica_tally["launches"][k] = \
                            replica_tally["launches"].get(k, 0) + v
            return pieces

        session_r.dispatch = tallied_dispatch
        base_r = serve(server_r, "smoke-3l-replica")
        proc, base_p, logp = start_replica_process(dev, base_t, work)
        procs.append(proc)

        def replica_up():
            if proc.poll() is not None:
                with open(logp) as f:
                    raise AssertionError("phase 3l (b): the replica "
                                         "process exited %d:\n%s"
                                         % (proc.returncode,
                                            f.read()[-3000:]))
            try:
                return http_json(base_p + "/healthz", timeout=10)
            except OSError:
                return None
        t_up = time.perf_counter()
        doc = wait_until(replica_up, "the replica process", 300, 0.5)
        proc_up_s = time.perf_counter() - t_up
        if doc["fleet"]["applied_version"] != 1:
            raise AssertionError("phase 3l (b): the replica process booted "
                                 "at v%d" % doc["fleet"]["applied_version"])
        versions0 = {"in_process": rb.inner.model_version,
                     "process": doc["model_version"]}
        bases = [base_r, base_p]
        for i in range(FLEET_PREDICT_THREADS):       # warm the buckets
            http_json(bases[i % 2] + "/predict", {"rows": reqs[i].tolist()})
        sync(dev)
        # the replica process's counts before the window (its boot
        # warm-up and the warm-up requests launched the walk already)
        health_p0 = http_json(base_p + "/healthz")
        kernels.reset_launch_counts()
        with tally_lock:
            replica_tally["on"] = True
        t0 = time.perf_counter()
        for i in range(FLEET_PREDICT_THREADS):
            th = threading.Thread(target=predict_loop,
                                  args=(i, bases[i % 2]),
                                  name="smoke-3l-predict-%d" % i)
            th.start()
            threads.append(th)
        time.sleep(FLEET_LATENCY_WINDOW_S)
        window[0] = "cycle"
        forwarded = None
        for p in range(FLEET_INGEST_POSTS):
            lo = p * chunk % (len(y) - chunk)
            body = {"rows": X[lo:lo + chunk].tolist(),
                    "labels": y[lo:lo + chunk].tolist()}
            if p == 0:
                out = http_json(base_r + "/ingest", body)
                forwarded = out.get("forwarded_to")
                if forwarded != base_t:
                    raise AssertionError("phase 3l (b): the replica "
                                         "relayed /ingest to %s, not %s: %s"
                                         % (forwarded, base_t, out))
            else:
                out = http_json(base_t + "/ingest", body)
                if out.get("rows") != chunk:
                    raise AssertionError("phase 3l (b): /ingest answered "
                                         "%s" % out)
        st = wait_until(
            lambda: (lambda s: s if s["trains"] >= 1 and s["last_result"]
                     not in ("idle", "skipped") else None)(trainer.state()),
            "the continue cycle", 300)
        if st["errors"] or st["promotions"] != 1:
            raise AssertionError("phase 3l (b): the continue cycle: %s" % st)
        head = store.latest_publish()["version"]
        wait_until(lambda: server_r.fleet_watcher.state()["applied_version"]
                   == head, "the in-process replica's adoption", 60)
        wait_until(lambda: http_json(base_p + "/healthz")["fleet"]
                   ["applied_version"] == head,
                   "the replica process's adoption", 60)
        t_adopted = time.perf_counter() - t0
        window[0] = "after"
        time.sleep(FLEET_LATENCY_WINDOW_S)
        stop.set()
        for th in threads:
            th.join(timeout=120)
        wall = time.perf_counter() - t0
        sync(dev)
        with tally_lock:
            replica_tally["on"] = False
        counts = kernels.launch_counts()
        health_p = http_json(base_p + "/healthz")
        health_r = server_r.healthz()
        pubs = store.publishes()
    finally:
        stop.set()
        predict_ops.predict_raw_impl = twin
        for th in threads:
            th.join(timeout=120)
        for proc in procs:
            stop_process(proc)
        for server, th in servers:
            server.shutdown()
            th.join(timeout=60)
            server.close()
    if failures:
        raise AssertionError("phase 3l (b): %d failed requests, first %s"
                             % (len(failures), failures[0]))
    if plain_calls:
        raise AssertionError("phase 3l (b): %d calls on the card reached "
                             "the plain twin (%s)" % (len(plain_calls),
                                                      plain_calls[:3]))
    if [p["event"] for p in pubs] != ["boot", "promotion"]:
        raise AssertionError("phase 3l (b): publishes %s" % pubs)
    # one version per publish on each replica
    fleet_r, fleet_p = health_r["fleet"], health_p["fleet"]
    for tag, f, v0, v1 in (("in-process", fleet_r, versions0["in_process"],
                            health_r["model_version"]),
                           ("process", fleet_p, versions0["process"],
                            health_p["model_version"])):
        if f["applied_version"] != head or f["swaps"] != len(pubs) - 1 \
                or v1 - v0 != len(pubs) - 1:
            raise AssertionError("phase 3l (b): the %s replica moved %d "
                                 "versions for %d publishes (%s)"
                                 % (tag, v1 - v0, len(pubs) - 1, f))
    # each replica's dispatches in the window and its raw walk launches
    # in the window: every dispatch must have launched the walk
    raw_launches = {
        "in_process": dict(
            dispatches=replica_tally["dispatches"],
            forest_raw=replica_tally["launches"].get("forest_raw", 0)),
        "process": {
            k: health_p[key].get(k, 0) - health_p0[key].get(k, 0)
            if isinstance(health_p[key], dict)
            else health_p[key] - health_p0[key]
            for k, key in (("dispatches", "dispatches"),
                           ("forest_raw", "kernel_launches"))}}
    for tag, c in raw_launches.items():
        if c["dispatches"] <= 0 or (dev.type == "cuda" and
                                    c["forest_raw"] < c["dispatches"]):
            raise AssertionError("phase 3l (b): the %s replica's %d "
                                 "dispatches in the window launched the "
                                 "raw walk %d times"
                                 % (tag, c["dispatches"], c["forest_raw"]))
    # each published version's scores, by the plain twin on the host
    expected = {}
    for p in pubs:
        b = lgt.Booster({"device_type": "cpu"},
                        model_str=store.load_model(p["version"]))
        sess = PredictSession(b, buckets=(FLEET_PREDICT_ROWS, 256))
        expected[p["version"]] = [sess.predict(r) for r in reqs]
    worst = 0.0
    served = set()
    for i, base, v, out in answers:
        errs = {u: float(np.max(np.abs(out - e[i])))
                for u, e in expected.items()}
        u = min(errs, key=errs.get)
        worst = max(worst, errs[u])
        if errs[u] != 0.0:
            raise AssertionError("phase 3l (b): an answer (replica %s, "
                                 "version %d) equals no published version "
                                 "(closest v%d, |diff| %.3g)"
                                 % (base, v, u, errs[u]))
        served.add(u)
    lat = {k: dict(n=len(v), p50=float(np.percentile(v, 50)),
                   p99=float(np.percentile(v, 99)))
           for k, v in latency.items() if v}
    if set(lat) != set(parts):
        raise AssertionError("phase 3l (b): no /predict answer in parts %s"
                             % sorted(set(parts) - set(lat)))
    summary = dict(
        answers=len(answers), failures=0, max_abs_err=worst,
        served_versions=sorted(served), publishes=len(pubs),
        predict_latency_ms=lat, wall_s=wall, adopted_s=t_adopted,
        replica_process_start_s=proc_up_s, forwarded_to_trainer=True,
        raw_launches=raw_launches, trainer=dict(
            promotions=st["promotions"], last_result=st["last_result"],
            lease_epoch=st["lease_epoch"], role=st["role"]))
    log("phase 3l (b) fleet serving: %d answers from %d threads on 2 "
        "replicas, 0 failures, every one a published version's (|diff| 0; "
        "served %s); publishes %s; both replicas one version a publish; "
        "raw walk launches %s; /predict ms (%d rows, %.0f ms pause) %s; "
        "adopted %.1f s after the first request, replica process up in "
        "%.1f s; launches %s"
        % (len(answers), FLEET_PREDICT_THREADS, sorted(served),
           [p["event"] for p in pubs], raw_launches, FLEET_PREDICT_ROWS,
           FLEET_PREDICT_PAUSE_S * 1e3,
           "; ".join("%s n %d p50 %.3f p99 %.3f"
                     % (k, lat[k]["n"], lat[k]["p50"], lat[k]["p99"])
                     for k in parts), t_adopted, proc_up_s,
           nonzero(counts)))
    return summary, counts


def buffer_sha256(tr):
    """sha256 over a trainer's shadow window and pending training rows
    (rows and labels, oldest first), the pending chunks read under the
    buffer's lock without draining them."""
    import hashlib
    import numpy as np
    buf = tr.buffer
    with buf._lock:
        pending = list(buf._chunks)
    parts = [buf.shadow()]
    if pending:
        parts.append((np.concatenate([c[0] for c in pending]),
                      np.concatenate([c[1] for c in pending])))
    h = hashlib.sha256()
    for part in parts:
        for a in (part if part is not None else ()):
            h.update(np.ascontiguousarray(a, np.float64).tobytes())
    return h.hexdigest()


def fleet_failover(dev, bst, data, seed, work):
    """(c) and (d). (c): a primary and a standby trainer (refit, lease ttl
    FLEET_TTL_S) over one directory on the card. The primary takes the
    lease, banks a win and buffers more rows, then closes without
    releasing the lease; the standby must take over within two ttl with
    the primary's watermark, win streak and buffer (sha256), and a
    publish by the fenced primary must raise StaleLeaseError and reach no
    replica. (d): the store compacted with ``snapshot_rows``; a cold
    trainer from the snapshot plus the tail must hold a buffer whose
    sha256 equals that of a full replay of the uncompacted copy."""
    import shutil
    import numpy as np
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.fleet import (FleetStore, ReplicaWatcher,
                                          StaleLeaseError)
    from lightgbm_tpu_torch.online import OnlineTrainer

    X, y = data[2], data[3]
    n = FLEET_DRILL_ROWS
    base_str = bst.model_to_string()
    root = os.path.join(work, "failover")
    kw = dict(mode="refit", trigger_rows=10 ** 9, min_rows=64,
              shadow_rows=4 * n, promote_threshold=FLEET_PROMOTE_THRESHOLD,
              promote_patience=2, lease_ttl_s=FLEET_TTL_S, start=False)

    def booster():
        return lgt.Booster({"device_type": dev.type}, model_str=base_str)

    def chunk(k):
        lo = (k * n) % (len(y) - n)
        return X[lo:lo + n], y[lo:lo + n]

    primary = OnlineTrainer(booster(), store=FleetStore(root, "m"),
                            holder_id="primary", **kw)
    if not primary.try_acquire():
        raise AssertionError("phase 3l (c): the primary took no lease")
    for k in range(3):
        primary.ingest(*chunk(k))
    if primary.run_once() != "deferred":
        raise AssertionError("phase 3l (c): the primary banked no win")
    for k in range(3, 5):
        primary.ingest(*chunk(k))
    want = primary.state()
    want_sha = buffer_sha256(primary)
    standby = OnlineTrainer(booster(), store=FleetStore(root, "m"),
                            holder_id="standby", **kw)
    if standby.try_acquire():
        raise AssertionError("phase 3l (c): the standby took a live lease")
    t0 = time.perf_counter()
    primary.close(release_lease=False)
    wait_until(standby.try_acquire, "the standby's takeover",
               4 * FLEET_TTL_S, 0.02)
    takeover_s = time.perf_counter() - t0
    got = standby.state()
    got_sha = buffer_sha256(standby)
    keys = ("consumed_rows", "win_streak", "buffered_rows", "shadow_rows")
    if takeover_s > 2 * FLEET_TTL_S or got_sha != want_sha \
            or any(got[k] != want[k] for k in keys):
        raise AssertionError("phase 3l (c): takeover after %.2f s (ttl "
                             "%g): %s against %s, buffers %s / %s"
                             % (takeover_s, FLEET_TTL_S,
                                {k: got[k] for k in keys},
                                {k: want[k] for k in keys}, got_sha[:12],
                                want_sha[:12]))
    try:
        primary._store.publish(base_str, event="promotion")
    except StaleLeaseError as exc:
        fenced = str(exc)
    else:
        raise AssertionError("phase 3l (c): the fenced primary published")
    # the standby's own publish is the only one a replica sees
    standby.ingest(*chunk(5))
    if standby.run_once() != "promoted":
        raise AssertionError("phase 3l (c): the standby did not promote")
    rstore = FleetStore(root, "m", read_only=True)
    replica = booster()
    watcher = ReplicaWatcher(replica, rstore, poll_interval_s=FLEET_POLL_S,
                             start=False)
    watcher.poll_once()
    pubs = rstore.publishes()
    if [(p["version"], p["lease_epoch"]) for p in pubs] \
            != [(1, got["lease_epoch"])] \
            or watcher.state()["applied_version"] != 1 \
            or replica.model_to_string() != rstore.load_model(1):
        raise AssertionError("phase 3l (c): publishes %s, replica at v%d"
                             % (pubs, watcher.state()["applied_version"]))
    # (d) snapshot compaction: a cold boot from snapshot + tail against a
    # full replay of an uncompacted copy
    for k in range(6, 8):
        standby.ingest(*chunk(k))
    full = os.path.join(work, "failover_full")
    shutil.copytree(root, full)
    st = standby.state()
    summary_c = standby._store.compact(
        watermark=st["consumed_rows"], wins=st["win_streak"],
        keep_rows=standby.buffer.shadow_capacity,
        snapshot_rows=standby.buffer.shadow_capacity)
    snap = summary_c.get("snapshot")
    if not isinstance(snap, dict) or not snap.get("rows"):
        raise AssertionError("phase 3l (d): no snapshot: %s" % summary_c)
    tail = chunk(8)
    for r in (root, full):
        FleetStore(r, "m").append_ingest(*tail)
    cold_kw = dict(kw, lease_ttl_s=0.0)
    cold = OnlineTrainer(booster(), store=FleetStore(root, "m"), **cold_kw)
    ref = OnlineTrainer(booster(), store=FleetStore(full, "m"), **cold_kw)
    cold_sha, ref_sha = buffer_sha256(cold), buffer_sha256(ref)
    cs, rs = cold.state(), ref.state()
    if cold_sha != ref_sha or any(cs[k] != rs[k] for k in keys):
        raise AssertionError("phase 3l (d): snapshot boot %s (%s) against "
                             "full replay %s (%s)"
                             % ({k: cs[k] for k in keys}, cold_sha[:12],
                                {k: rs[k] for k in keys}, ref_sha[:12]))
    kinds = [e["kind"] for e in FleetStore(root, "m").events()]
    for tr in (standby, cold, ref):
        tr.close()
    summary = dict(
        takeover_s=takeover_s, ttl_s=FLEET_TTL_S,
        watermark=got["consumed_rows"], win_streak=got["win_streak"],
        buffer_sha256=got_sha, lease_epoch=got["lease_epoch"],
        zombie_refused=fenced, snapshot_rows=snap["rows"],
        snapshot_bytes=snap.get("bytes"),
        log_kinds_after_compaction=sorted(set(kinds)),
        snapshot_boot_sha256=cold_sha)
    log("phase 3l (c) failover: the standby took the lease %.2f s after "
        "the primary closed (ttl %g s) at epoch %d with its watermark %d, "
        "win streak %d and buffer (sha256 %s...); the fenced primary's "
        "publish raised StaleLeaseError, the replica adopted only the "
        "standby's v1. (d) snapshot of %d rows: a cold boot's buffer "
        "sha256 %s... equals the full replay's"
        % (takeover_s, FLEET_TTL_S, got["lease_epoch"],
           got["consumed_rows"], got["win_streak"], got_sha[:12],
           snap["rows"], cold_sha[:12]))
    return summary


def phase_fleet(dev, data, card, trees=40, leaves=255, seed=0,
                timed=True, kind_rows=None):
    """Phase 3l, the fleet at full width on the card: (a) the raw walk
    against its twin (fleet_raw_checks, the edge packs first); (b) a
    shared-directory fleet of a trainer and two replicas serving and
    training (fleet_serving); (c) failover and (d) snapshot compaction
    (fleet_failover). The served model: ``trees`` fused trees of
    ``leaves`` leaves on the script's training rows. Returns (summary,
    launch counts of (b), the raw walk's kernels-line row or None, check
    errors). ``timed=False`` and ``kind_rows`` rehearse it on the host
    (tests/test_torch_fleet.py)."""
    import numpy as np
    import lightgbm_tpu_torch as lgt

    X, y = data[0], data[1]
    t0 = time.perf_counter()
    bst = lgt.train(dict(API_PARAMS, num_leaves=leaves, device_type=dev.type),
                    lgt.Dataset(X, label=y), trees)
    train_s = time.perf_counter() - t0
    errs = phase_raw_kernels(dev, np.random.RandomState(seed + 89))
    row, shapes = fleet_raw_checks(dev, bst, data[2], seed, errs,
                                   timed=timed, kind_rows=kind_rows)
    for name, e in sorted(errs.items()):
        log("check %s: max |diff| %.3g" % (name, e))
    work = tempfile.mkdtemp(prefix="smoke-3l-")
    try:
        serving, counts = fleet_serving(dev, bst, data, seed, work)
        failover = fleet_failover(dev, bst, data, seed, work)
    finally:
        shutil_rmtree(work)
    if row is not None:
        row["launches_main_path"] = counts.get("forest_raw", 0)
    summary = dict(train_s=train_s, raw_shapes=shapes, serving=serving,
                   failover=failover)
    log("phase 3l (%s): model %d trees x %d leaves trained in %.1f s"
        % (card, trees, leaves, train_s))
    return summary, counts, row, errs


# ------------------------------------------------------------ parallel phase

#: phase 3m: the distributed learners at full width (the training rows of
#: phase 3, 255 bins, 255 leaves, binary, with the valid set, per
#: iteration), ranks on the one card. Cut: PARALLEL_TREES trees a run
#: (from the 4 first planned: ranks sharing one card grow a tree in 2-5 s,
#: and the whole script must keep its time on the slower machines)
PARALLEL_TREES = 2
#: voting's top_k: at F = 28 the default 20 gives 2k >= F (every feature
#: merged)
PARALLEL_TOP_K = 8
#: the modes run at D = 2 (name, tree_learner, extra params)
PARALLEL_MODES = (("data", "data", {}),
                  ("data_noscatter", "data", {"tpu_hist_scatter": False}),
                  ("feature", "feature", {}),
                  ("voting", "voting", {"top_k": PARALLEL_TOP_K}),
                  ("int8", "data", {"use_quantized_grad": True}))
#: the int8 run shows each rank's B2 and B6: cut to 1 tree
PARALLEL_INT8_TREES = 1
#: valid AUC against serial's (tests/test_parallel.py:67's bounds; int8
#: against the f32 serial model as phase 4 holds it)
PARALLEL_AUC_TOL = {"data": 0.005, "data_noscatter": 0.005, "feature": 0.03,
                    "voting": 0.03, "int8": AUC_TOL}
PARALLEL_HOST_TREES = 3
PARALLEL_HOST_LEAVES = 63
PARALLEL_CSV_ROWS = 200_000
PARALLEL_LOAD_TREES = 3
#: the kernels every rank's f32 and int8 runs must launch (B1, B5, B3;
#: B2, B6, B3)
PARALLEL_F32_KERNELS = ("partition_segment", "segment_histogram",
                        "route_rows")
PARALLEL_INT8_KERNELS = ("partition_segment_rows", "segment_histogram_q",
                         "route_rows")
#: a rank group's time limit: every join inside it times out within this
PARALLEL_GROUP_TIMEOUT_S = 900


def l2_grid_labels(X):
    """L2 labels on the 1/64 grid within [-1/8, 1/8]: every f32 sum of
    up to 2^21 of them (and of the unit hessians and counts) is exact in
    any order, so one tree grown from them is the same tree however its
    sums are split over ranks."""
    import numpy as np
    return np.clip(np.round(higgs_signal(X) * 8.0), -8, 8) / 64.0


def tree_block(text, k=0):
    """The ``Tree=k`` block of a model text."""
    head = "Tree=%d\n" % k
    start = text.index(head)
    end = text.find("\n\n", start)
    return text[start:end if end >= 0 else len(text)]


def first_difference(a, b):
    """Where two model texts' first trees differ: for each line that
    differs, its key and the differing entries (index and both values)."""
    out = []
    for la, lb in zip(tree_block(a).split("\n"), tree_block(b).split("\n")):
        if la != lb:
            key, _, va = la.partition("=")
            vb = lb.partition("=")[2]
            diffs = [(i, x, y) for i, (x, y) in enumerate(
                zip(va.split(), vb.split())) if x != y]
            out.append("  %s: %d entries differ, first %s"
                       % (key, len(diffs), diffs[:6]))
    return "\n".join(out) or "  (one block is a prefix of the other)"


def same_first_tree(a, b):
    """Two model texts' first trees: the same structure and counts, and
    leaf values equal as numbers (a zero's sign aside: a sum that the
    SplitInfo sync carries may turn -0.0 into 0.0, as the JAX package's
    masked sum does)."""
    import numpy as np
    import lightgbm_tpu_torch as lgt
    ta, tb = (lgt.Booster({"device_type": "cpu"}, model_str=t).inner
              .models[0] for t in (a, b))
    k = ta.num_internal
    return ta.num_leaves == tb.num_leaves and all(
        np.array_equal(getattr(ta, f)[:k], getattr(tb, f)[:k])
        for f in ("split_feature", "threshold", "decision_type",
                  "left_child", "right_child")) and np.array_equal(
        ta.leaf_count[:ta.num_leaves], tb.leaf_count[:tb.num_leaves]) \
        and np.array_equal(ta.leaf_value[:ta.num_leaves],
                           tb.leaf_value[:tb.num_leaves])


def gloo_cuda_probe(dev, world):
    """Which gloo collectives take card tensors under this torch (the
    port's Comm stages card tensors through pinned host memory for a
    gloo group either way)."""
    import torch
    import torch.distributed as dist
    x = torch.arange(8 * world, dtype=torch.float32, device=dev)
    probes = {}
    tries = (("all_reduce", lambda: dist.all_reduce(x.clone())),
             ("broadcast", lambda: dist.broadcast(x.clone(), 0)),
             ("all_gather", lambda: dist.all_gather(
                 [torch.empty_like(x) for _ in range(world)], x)),
             ("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
                 torch.empty(8, device=dev), x)))
    for name, fn in tries:
        try:
            fn()
            torch.cuda.synchronize(dev)
            probes[name] = "accepted"
        except Exception as e:   # the probe reports, the Comm stages
            probes[name] = "refused: %s" % str(e).splitlines()[0][:120]
        dist.barrier()
    return probes


def par_train(dev, npz, valid_npz, params, trees, label=None,
              want_text=False):
    """A rank's ``lgt.train`` of ``trees`` iterations with the valid set:
    model sha256, wall, the valid metrics, this run's launch counts, the
    comm's collectives and bytes, the learner class."""
    import hashlib
    import numpy as np
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import kernels

    p = dict(params, device_type=dev.type)
    train = lgt.Dataset(npz, label=None if label is None else np.load(label),
                        params=p)
    train.construct()
    valid = [lgt.Dataset(valid_npz, params=p)] if valid_npz else []
    evals = {}
    stamps = []

    def stamp(env):
        # a callback: every booster trains per iteration, serial too
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stamps.append(time.perf_counter())

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    bst = lgt.train(p, train, trees, valid_sets=valid,
                    callbacks=[lgt.record_evaluation(evals), stamp])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    per_tree = np.diff([t0] + stamps) * 1e3
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    text = bst.model_to_string()
    lrn = bst.inner.learner
    comm = getattr(lrn, "comm", None)
    out = dict(sha=hashlib.sha256(text.encode()).hexdigest(), wall_s=wall,
               wall_per_tree_ms=wall / trees * 1e3,
               tree_ms=[float(v) for v in per_tree],
               steady_tree_ms=float(np.median(per_tree[1:]))
               if len(per_tree) > 1 else float(per_tree[0]),
               launches=counts,
               learner=type(lrn).__name__, fused=bst.inner.supports_fused(),
               comm=dict(comm.stats) if comm is not None else {},
               metrics={k: v[-1] for k, v in evals.get("valid_0",
                                                         {}).items()},
               auc_by_tree=list(evals.get("valid_0", {}).get("auc", [])),
               train_metric=bst.eval_train()[0][2] if not valid else None,
               init_scores=[float(v) for v in bst.inner.init_scores],
               num_trees=len(bst.inner.models))
    if want_text:
        out["text"] = text
    return out


def load_and_train(dev, csv, params, trees, sharded=True):
    """``io.load_dataset_sharded`` of ``csv`` (default gathers over the
    group when ``sharded``, else every row) and ``trees`` iterations on it
    per iteration (a callback: the distributed learners' per-split host
    loop; data-parallel when sharded, else serial). Returns the bins, the
    model text, the load's seconds and the init scores."""
    import hashlib
    import numpy as np
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io import load_dataset_sharded

    p = dict(params, device_type=dev.type,
             tree_learner="data" if sharded else "serial")
    t0 = time.perf_counter()
    ds = load_dataset_sharded(csv, Config.from_params(p)) if sharded \
        else load_dataset_sharded(csv, Config.from_params(p), rank=0,
                                  world=1)
    load_s = time.perf_counter() - t0
    wrap = lgt.Dataset(None)
    wrap._constructed = ds
    bst = lgt.train(p, wrap, trees, callbacks=[lambda env: None])
    text = bst.model_to_string()
    return dict(binned=ds.binned, shard_info=ds.shard_info, load_s=load_s,
                text=text, sha=hashlib.sha256(text.encode()).hexdigest(),
                learner=type(bst.inner.learner).__name__,
                local_label_mean=float(np.mean(ds.metadata.label)),
                init_scores=[float(v) for v in bst.inner.init_scores])


PARALLEL_CASES = {"train": par_train, "load": load_and_train}


def gloo_latency(group, reps=20):
    """Milliseconds a gloo collective of the group takes on host tensors of
    a histogram's size (28 x 256 x 3 f32) and a SplitInfo's (2 x 280), the
    median of ``reps`` after 3 warm-ups."""
    import numpy as np
    import torch
    import torch.distributed as dist
    d = dist.get_world_size(group)
    out = {}
    for size in (28 * 256 * 3, 2 * 280):
        x = torch.ones(size - size % d)
        parts = [torch.empty_like(x) for _ in range(d)]
        blk = torch.empty(x.numel() // d)
        rs = getattr(dist, "reduce_scatter_single", None) \
            or dist.reduce_scatter_tensor
        for name, fn in (("all_reduce", lambda: dist.all_reduce(
                             x, group=group)),
                         ("all_gather", lambda: dist.all_gather(
                             parts, x, group=group)),
                         ("reduce_scatter", lambda: rs(blk, x,
                                                       group=group))):
            times = []
            for i in range(reps + 3):
                t0 = time.perf_counter()
                fn()
                if i >= 3:
                    times.append((time.perf_counter() - t0) * 1e3)
            out["%s_%d" % (name, size)] = float(np.median(times))
    return out


def rank_warmup(dev):
    """What a rank's first training would pay once: the kernels bound,
    the card's context, the pinned-memory pool."""
    import torch
    from lightgbm_tpu_torch.linear import fit as linear_fit  # noqa: F401
    from lightgbm_tpu_torch.ops import (commit, forest,  # noqa: F401
                                        histogram, kernels, monotone, node,
                                        partition, rank, route, scan)
    if dev.type == "cuda":
        kernels.build_all()
        x = torch.ones(1 << 20, device=dev)
        torch.empty(x.shape, pin_memory=True).copy_(x)
        torch.cuda.synchronize(dev)


def parallel_rank(rank, world, work):
    """One rank of a phase 3m group: join the group (a ``file://`` store
    in ``work``; on the card the rank's is ``cuda:(rank % count)``), warm
    up, then wait for ``work/cases.pkl`` (the parent writes it once the
    inputs are ready), run every case in order and write
    ``work/out_<rank>.pkl``. A case of ``D`` ranks runs on the group of
    ranks ``[0, D)`` (the others go on to the next case); ``on_card`` on
    the group's device (the host when the phase rehearses there), else on
    the host."""
    import pickle
    import torch
    import torch.distributed as dist
    from lightgbm_tpu_torch.parallel.distributed import (backend,
                                                         global_mesh,
                                                         init_distributed,
                                                         make_mesh)
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    with open(os.path.join(work, "device")) as f:
        device_type = f.read().strip()
    init_distributed("file://" + os.path.join(work, "store"), world, rank,
                     device_type=device_type,
                     timeout_s=PARALLEL_GROUP_TIMEOUT_S)
    card_dev = torch.device("cuda", torch.cuda.current_device()) \
        if device_type == "cuda" else torch.device("cpu")
    rank_warmup(card_dev)
    # every rank makes the group of the first two ranks (the D = 2 cases)
    groups = {2: make_mesh(2), world: make_mesh(world)}
    out = {"backend": backend(), "device": str(card_dev),
           "probe": gloo_cuda_probe(card_dev, world)
           if backend() == "gloo" and device_type == "cuda" else {},
           "latency_ms": {d: gloo_latency(g) for d, g in groups.items()
                          if rank < d}}
    spec = os.path.join(work, "cases.pkl")
    deadline = time.perf_counter() + PARALLEL_GROUP_TIMEOUT_S
    while not os.path.exists(spec):
        if time.perf_counter() > deadline:
            raise RuntimeError("no cases after %d s"
                               % PARALLEL_GROUP_TIMEOUT_S)
        time.sleep(0.05)
    with open(spec, "rb") as f:
        cases = pickle.load(f)
    for name, kind, on_card, d, kw in cases:
        dist.barrier()     # each case starts on every rank of it at once
        if rank >= d:
            continue
        dev = card_dev if on_card else torch.device("cpu")
        t0 = time.perf_counter()
        with global_mesh(group=groups[d]):
            out[name] = PARALLEL_CASES[kind](dev, **kw)
        out[name]["case_s"] = time.perf_counter() - t0
    with open(os.path.join(work, "out_%d.pkl" % rank), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


class RankGroup:
    """``world`` ranks of this script (``--parallel-rank``) on ``dev``'s
    type, started at once: they join, warm up and wait for their cases
    while the caller prepares the inputs."""

    def __init__(self, dev, world, work):
        os.makedirs(work, exist_ok=True)
        self.world, self.work = world, work
        with open(os.path.join(work, "device"), "w") as f:
            f.write(dev.type)
        env = dict(os.environ, PYTHONPATH=HERE)
        self.procs, self.logs = [], []
        for rank in range(world):
            logp = os.path.join(work, "rank%d.log" % rank)
            self.logs.append(logp)
            with open(logp, "w") as lf:
                self.procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--parallel-rank", str(rank), str(world), work],
                    stdout=lf, stderr=subprocess.STDOUT, env=env, cwd=HERE))

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def run(self, cases, timeout_s=PARALLEL_GROUP_TIMEOUT_S):
        """Hand the ranks ``cases`` (``(name, kind, on_card, D, kwargs)``)
        and wait for all of them (a failed or late rank kills the group
        and fails the phase); their outputs in rank order."""
        import pickle
        tmp = os.path.join(self.work, "cases.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(cases, f)
        os.replace(tmp, os.path.join(self.work, "cases.pkl"))
        deadline = time.perf_counter() + timeout_s
        failed = None
        procs = self.procs
        try:
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs):
                    failed = "a rank failed"
                    break
                if time.perf_counter() > deadline:
                    failed = "timed out after %d s" % timeout_s
                    break
                time.sleep(0.1)
            if failed is None and any(p.returncode != 0 for p in procs):
                failed = "a rank failed"
        finally:
            self.kill()
        if failed:
            for rank, logp in enumerate(self.logs):
                with open(logp) as lf:
                    log("rank %d of %d (rc %s):\n%s"
                        % (rank, self.world, procs[rank].returncode,
                           lf.read()[-4000:]))
            raise AssertionError("phase 3m: group of %d ranks: %s"
                                 % (self.world, failed))
        outs = []
        for rank in range(self.world):
            with open(os.path.join(self.work, "out_%d.pkl" % rank),
                      "rb") as f:
                outs.append(pickle.load(f))
        return outs


def run_rank_group(dev, world, cases, work,
                   timeout_s=PARALLEL_GROUP_TIMEOUT_S):
    """Start a RankGroup of ``world`` ranks and run ``cases`` on it."""
    return RankGroup(dev, world, work).run(cases, timeout_s)


def collective_bytes(mode, world, num_grp, num_bin, rows, splits, num_feat,
                     top_k):
    """The collective payload bytes (a rank's input to each collective) of
    one tree of ``splits`` splits, from the shapes: the root sums (12 B)
    and histogram, then per split the smaller child's (G, B, 3) f32
    histogram (all-reduce; reduce-scatter in scatter mode, G padded to D
    blocks); the SplitInfo sync of feature and scatter modes (one
    all-gather of a node's gain and fields, B + 23 f32); voting's (F,)
    votes and (2k, B, 3) merged rows a node; the (N / D) int32 gather of
    the rows' leaves."""
    hist = num_grp * num_bin * 12
    scat = -(-num_grp // world) * world * num_bin * 12
    info = 4 * (num_bin + 23)                # a node
    vote = 4 * num_feat + min(2 * top_k, num_feat) * num_bin * 12
    root, per = {"feature": (info, 2 * info),
                 "voting": (12 + vote, 2 * vote),
                 "data_noscatter": (12 + hist, hist)}.get(
        mode, (12 + scat + info, scat + 2 * info))
    gather = 0 if mode == "feature" else 4 * (-(-rows // world))
    return root + splits * per + gather


def phase_parallel(dev, data, card, trees=PARALLEL_TREES, leaves=255,
                   host_rows=200_000, serial=None):
    """Phase 3m: the distributed learners at full width on the card, ranks
    sharing it over gloo (one process a rank; NCCL refuses two ranks on one
    card). The parent bins phase 3's rows once and writes the npz every
    rank trains on; then, against the serial per-iteration model of the
    same run (``tpu_split_kernel=off``: the chain's kernels, which the
    distributed trees take), at D = 2: data with and without
    ``tpu_hist_scatter``, feature, voting (``top_k=8``) and int8 data, each
    ``trees`` trees; data again (sha256-equal); the first tree of data and
    of feature on 1/64-grid L2 labels byte-equal to serial's; card against
    host at ``host_rows`` rows x 3 trees x 63 leaves; a sharded load of a
    200,000-row CSV. At D = 4: data. Every rank's model sha256-equal to
    the others', every rank launched B1, B5 and B3 (B2, B6 and B3 in the
    int8 run) and never B7, valid AUC within PARALLEL_AUC_TOL of serial's.
    ``serial`` is that model's ``phase_train`` summary when the caller
    trained it (phase 3 of the full run: the same rows, parameters and
    path); else it is trained here. Returns the summary."""
    params = dict(train_params(dev, leaves), verbosity=-1,
                  tpu_split_kernel="off")
    work = tempfile.mkdtemp(prefix="smoke-3m-")
    group = None
    try:
        # one group of 4 ranks, started first: they join and warm up while
        # this process writes their inputs; the D = 2 cases run on its
        # first two ranks (the others wait), then D = 4 on all of them
        t_group = time.perf_counter()
        group = RankGroup(dev, 4, os.path.join(work, "group"))
        return _parallel_cases(dev, data, card, trees, leaves, host_rows,
                               work, serial, params, group, t_group)
    finally:
        if group is not None:
            group.kill()
        shutil_rmtree(work)


def _parallel_cases(dev, data, card, trees, leaves, host_rows, work, serial,
                    params, group, t_group):
    import numpy as np
    import lightgbm_tpu_torch as lgt

    X, y, Xv, yv = data
    t0 = time.perf_counter()
    train = lgt.Dataset(X, label=y, params=params)
    train.construct()
    valid = lgt.Dataset(Xv, label=yv, reference=train)
    valid.construct()
    npz, vnpz = (os.path.join(work, n) for n in ("train.npz", "valid.npz"))
    train.save_binary(npz)
    valid.save_binary(vnpz)
    l2 = os.path.join(work, "l2.npy")
    np.save(l2, l2_grid_labels(X))
    host_npz = os.path.join(work, "host.npz")
    host_params = dict(params, num_leaves=PARALLEL_HOST_LEAVES,
                       metric=["binary_logloss"])
    lgt.Dataset(X[:host_rows], label=y[:host_rows],
                params=host_params).save_binary(host_npz)
    csv = os.path.join(work, "load.csv")
    write_csv(csv, X[:PARALLEL_CSV_ROWS], y[:PARALLEL_CSV_ROWS])
    prep_s = time.perf_counter() - t0
    log("phase 3m: binned and wrote the ranks' inputs in %.1f s" % prep_s)

    # ---- serial references in this process, on the card ----
    if serial is None:
        serial = par_train(dev, npz, vnpz, params, trees)
    else:
        serial = dict(wall_per_tree_ms=serial["wall_per_tree_ms"],
                      steady_tree_ms=serial["steady_tree_ms"],
                      auc_by_tree=serial["valid_auc_by_tree"],
                      metrics={"auc": serial["valid_auc_by_tree"][
                          trees - 1]}, launches="phase 3's")
    l2_params = dict(params, objective="regression", metric=["l2"],
                     boost_from_average=False)
    serial_l2 = par_train(dev, npz, None, l2_params, 1, label=l2,
                          want_text=True)
    log("phase 3m serial (%s): per iteration %.1f ms a tree (%.1f from the "
        "second), valid auc after %d trees %.5f; launches %s" % (
            card, serial["wall_per_tree_ms"], serial["steady_tree_ms"],
            trees, serial["metrics"]["auc"], serial["launches"]))

    cases = [(name, "train", True, 2, dict(
        npz=npz, valid_npz=vnpz, params=dict(params, tree_learner=tl,
                                             **extra),
        trees=PARALLEL_INT8_TREES if name == "int8" else trees))
        for name, tl, extra in PARALLEL_MODES]
    cases.append(("data_again", "train", True, 2, dict(
        npz=npz, valid_npz=vnpz, params=dict(params, tree_learner="data"),
        trees=trees)))
    for tl in ("data", "feature"):
        cases.append(("l2_" + tl, "train", True, 2, dict(
            npz=npz, valid_npz=None, params=dict(l2_params, tree_learner=tl),
            trees=1, label=l2, want_text=True)))
    for name, on_card in (("host_card", True), ("host_cpu", False)):
        cases.append((name, "train", on_card, 2, dict(
            npz=host_npz, valid_npz=None,
            params=dict(host_params, tree_learner="data"),
            trees=PARALLEL_HOST_TREES, want_text=True)))
    load_params = dict(params, boost_from_average=False,
                       metric=["binary_logloss"])
    cases.append(("load", "load", True, 2, dict(
        csv=csv, params=load_params, trees=PARALLEL_LOAD_TREES)))
    # the single-rank reference of the sharded load: every row, serial
    whole = load_and_train(dev, csv, load_params, PARALLEL_LOAD_TREES,
                           sharded=False)
    cases.append(("data_d4", "train", True, 4, dict(cases[0][4])))
    t0 = time.perf_counter()
    outs = group.run(cases)
    group_s = time.perf_counter() - t0
    log("phase 3m: the ranks ran their cases in %.1f s (%.1f s since they "
        "started); gloo ms on host tensors by group size %s"
        % (group_s, time.perf_counter() - t_group, outs[0]["latency_ms"]))
    g2 = outs[:2]
    g4 = [{"data": o["data_d4"]} for o in outs]

    log("phase 3m: cases by seconds (rank 0): %s" % (", ".join(
            "%s %.1f" % (k, v["case_s"]) for k, v in outs[0].items()
            if isinstance(v, dict) and "case_s" in v)))
    summary = dict(serial_wall_per_tree_ms=serial["wall_per_tree_ms"],
                   serial_steady_tree_ms=serial["steady_tree_ms"],
                   serial_valid_auc=serial["metrics"]["auc"],
                   prep_s=prep_s, group_s=group_s,
                   backend=outs[0]["backend"], probe=outs[0]["probe"],
                   latency_ms=outs[0]["latency_ms"],
                   devices=[o["device"] for o in outs], modes={})
    num_grp = train.construct().num_groups
    num_feat = train.construct().num_features
    for world, outs, names in ((2, g2, [m[0] for m in PARALLEL_MODES]
                                + ["data_again"]), (4, g4, ["data"])):
        for name in names:
            runs = [o[name] for o in outs]
            shas = {r["sha"] for r in runs}
            if len(shas) != 1:
                raise AssertionError("phase 3m D=%d %s: the ranks' models "
                                     "differ" % (world, name))
            r0 = runs[0]
            mode = "int8" if name == "int8" else name.replace("_again", "")
            auc = r0["metrics"]["auc"]
            n_trees = r0["num_trees"]
            # serial's valid AUC after as many trees
            serial_auc = serial["auc_by_tree"][n_trees - 1]
            tol = PARALLEL_AUC_TOL[mode]
            want = PARALLEL_INT8_KERNELS if mode == "int8" \
                else PARALLEL_F32_KERNELS
            for rank, r in enumerate(runs):
                miss = [k for k in want if r["launches"].get(k, 0) <= 0] \
                    if dev.type == "cuda" else []
                if miss or r["launches"].get("one_kernel_split", 0):
                    raise AssertionError(
                        "phase 3m D=%d %s rank %d: launches %s (missing %s; "
                        "the one-kernel split is ineligible under a comm)"
                        % (world, name, rank, r["launches"], miss))
                if r["fused"]:
                    raise AssertionError("phase 3m: a distributed booster "
                                         "took the fused blocks")
            expect = {"data": "DataParallelTreeLearner",
                      "feature": "FeatureParallelTreeLearner",
                      "voting": "VotingParallelTreeLearner"}[
                          "data" if mode in ("data_noscatter", "int8")
                          else mode]
            if r0["learner"] != expect:
                raise AssertionError("phase 3m %s: learner %s"
                                     % (name, r0["learner"]))
            shape_bytes = collective_bytes(
                "data" if mode == "int8" else mode, world, num_grp,
                params["max_bin"], len(y), leaves - 1, num_feat,
                PARALLEL_TOP_K)
            row = dict(world=world, sha256=r0["sha"], trees=n_trees,
                       wall_per_tree_ms=[r["wall_per_tree_ms"] for r in runs],
                       steady_tree_ms=[r["steady_tree_ms"] for r in runs],
                       valid_auc=auc, serial_valid_auc=serial_auc,
                       auc_gap=abs(auc - serial_auc),
                       collective_bytes_per_tree_shapes=shape_bytes,
                       collective_bytes_per_tree_measured=[
                           r["comm"]["bytes"] / n_trees for r in runs],
                       staged_bytes_per_tree=[
                           r["comm"]["staged_bytes"] / n_trees
                           for r in runs],
                       collectives_per_tree=r0["comm"]["collectives"]
                       / n_trees, case_s=[r["case_s"] for r in runs],
                       launches=[r["launches"] for r in runs])
            summary["modes"]["%s_d%d" % (name, world)] = row
            log("phase 3m D=%d %s (%s, %s over one card: no scaling "
                "figure): %d trees, wall a tree %s ms, from the second tree "
                "%s (serial %.1f, %.1f); valid auc %.5f "
                "(serial %.5f, |diff| %.5f, limit %.3f); collective bytes a "
                "tree %d by the shapes, %s measured (%.1f collectives a "
                "tree), staged through host %s; every rank's model %s; "
                "launches by rank %s" % (
                    world, name, card, summary["backend"], n_trees,
                    ", ".join("%.1f" % v for v in row["wall_per_tree_ms"]),
                    ", ".join("%.1f" % v for v in row["steady_tree_ms"]),
                    serial["wall_per_tree_ms"], serial["steady_tree_ms"],
                    auc, serial_auc, row["auc_gap"], tol,
                    shape_bytes, ", ".join("%.0f" % v for v in
                                           row["collective_bytes_per_tree_"
                                               "measured"]),
                    row["collectives_per_tree"],
                    ", ".join("%.0f" % v for v in
                              row["staged_bytes_per_tree"]),
                    r0["sha"][:16], row["launches"]))
            if row["auc_gap"] > tol:
                raise AssertionError("phase 3m D=%d %s: valid auc %.5f vs "
                                     "serial %.5f" % (world, name, auc,
                                                      serial_auc))
    if g2[0]["data_again"]["sha"] != g2[0]["data"]["sha"]:
        raise AssertionError("phase 3m: two D=2 data runs differ")
    # ---- the first tree on exact sums: byte-equal to serial's ----
    want = tree_block(serial_l2["text"])
    for tl in ("data", "feature"):
        for rank, o in enumerate(g2):
            if tree_block(o["l2_" + tl]["text"]) != want:
                raise AssertionError(
                    "phase 3m: the first %s tree on the 1/64-grid L2 labels "
                    "(rank %d) is not serial's:\n%s" % (
                        tl, rank, first_difference(o["l2_" + tl]["text"],
                                                   serial_l2["text"])))
    log("phase 3m: on 1/64-grid L2 labels the first tree of data and of "
        "feature at D=2 equals the serial tree byte for byte (%d bytes)"
        % len(want))
    # ---- card against host, the same group ----
    hc, hh = g2[0]["host_card"], g2[0]["host_cpu"]
    for o in g2:
        if o["host_card"]["sha"] != hc["sha"] or \
                o["host_cpu"]["sha"] != hh["sha"]:
            raise AssertionError("phase 3m card vs host: the ranks differ")
    ca = lgt.Booster({"device_type": "cpu"}, model_str=hc["text"])
    ho = lgt.Booster({"device_type": "cpu"}, model_str=hh["text"])
    agree, total, first = split_agreement(ca, ho)
    log("phase 3m card vs host (D=2 data, %d rows x %d trees x %d leaves): "
        "%d of %d splits agree (first tree %d of %d); train logloss card "
        "%.7f host %.7f; card %.1f s, host %.1f s" % (
            host_rows, PARALLEL_HOST_TREES, PARALLEL_HOST_LEAVES, agree,
            total, first[0], first[1], hc["train_metric"],
            hh["train_metric"], hc["wall_s"], hh["wall_s"]))
    if first[0] != first[1] or \
            abs(hc["train_metric"] - hh["train_metric"]) > LOGLOSS_TOL:
        raise AssertionError("phase 3m: card and host groups disagree")
    summary["card_vs_host"] = dict(splits_agree=agree, splits=total,
                                   first_tree=first,
                                   logloss_card=hc["train_metric"],
                                   logloss_host=hh["train_metric"])
    # ---- the sharded load ----
    ld = [o["load"] for o in g2]
    n_csv = whole["shard_info"][2]
    for r, o in enumerate(ld):
        r0, r1 = r * n_csv // 2, (r + 1) * n_csv // 2
        if o["shard_info"] != (r, 2, n_csv) or \
                not np.array_equal(o["binned"], whole["binned"][r0:r1]):
            raise AssertionError("phase 3m: rank %d's shard %s is not the "
                                 "whole load's rows" % (r, o["shard_info"]))
    if ld[0]["sha"] != ld[1]["sha"]:
        raise AssertionError("phase 3m: the sharded models differ by rank")
    sh = lgt.Booster({"device_type": "cpu"}, model_str=ld[0]["text"])
    wh = lgt.Booster({"device_type": "cpu"}, model_str=whole["text"])
    agree, total, first = split_agreement(sh, wh)
    load_bytes = tree_block(ld[0]["text"]) == tree_block(whole["text"])
    if not load_bytes:
        log("phase 3m sharded load: the first trees' texts differ:\n"
            + first_difference(ld[0]["text"], whole["text"]))
    if not same_first_tree(ld[0]["text"], whole["text"]):
        raise AssertionError("phase 3m: the first tree on the sharded load "
                             "is not the whole load's")
    summary["load"] = dict(shard_info=[r["shard_info"] for r in ld],
                           load_s=[r["load_s"] for r in ld],
                           whole_load_s=whole["load_s"],
                           splits_agree=agree, splits=total,
                           sharded_sha256=ld[0]["sha"],
                           whole_sha256=whole["sha"],
                           first_tree_bytes_equal=load_bytes)
    log("phase 3m sharded load (%d rows, 2 ranks, default gathers): shards "
        "%s, bins equal to the whole load's rows; %d data-parallel trees "
        "against the serial ones on the whole file: first tree equal (%s), "
        "%d of %d splits agree; load %s s (the whole file %.2f)" % (
            n_csv, summary["load"]["shard_info"], PARALLEL_LOAD_TREES,
            "byte for byte" if load_bytes else
            "splits, counts and leaf values; the text differs", agree, total,
            ", ".join("%.2f" % v for v in summary["load"]["load_s"]),
            whole["load_s"]))
    log("phase 3m: gloo on card tensors under torch %s: %s"
        % (__import__("torch").__version__, summary["probe"]))
    return summary


def shutil_rmtree(path):
    import shutil
    shutil.rmtree(path, ignore_errors=True)


def main(argv=None):
    try:
        return run(argv)
    finally:
        stop_host_pool()


def run(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trees", type=int, default=40)
    ap.add_argument("--leaves", type=int, default=255)
    ap.add_argument("--train-rows", type=int, default=TRAIN_ROWS)
    ap.add_argument("--valid-rows", type=int, default=VALID_ROWS)
    ap.add_argument("--host-rows", type=int, default=200_000)
    ap.add_argument("--binned-rows", type=int, default=BINNED_ROWS)
    ap.add_argument("--rows-only", action="store_true",
                    help="build, train phase 4 (quantized, rows layout) "
                    "and print only its model's sha256, its kernels' "
                    "in-run ms and full_width_rows_kernels")
    ap.add_argument("--planes-route-only", action="store_true",
                    help="build, train phase 3 (planes, three launches) "
                    "and print only its model's sha256, the in-run ms of "
                    "K3 planes and the router, full_width_planes and "
                    "full_width_route")
    ap.add_argument("--forest-only", action="store_true",
                    help="build, train the serving model (phase 4) and "
                    "print only the forest kernel against its twin and "
                    "its timings (full_width_forest) and the median "
                    "PredictSession.predict latency at REQUEST_ROWS")
    ap.add_argument("--fused-only", action="store_true",
                    help="build, check the split commit and the one-kernel "
                    "header, train phase 3b (per iteration) and phase 3d "
                    "(fused blocks) and print only their summaries")
    ap.add_argument("--file-only", action="store_true",
                    help="build, run the file phase (2b: native and numpy "
                    "construction at full size, CSV files through the CLI "
                    "on the card) and print only its summary")
    ap.add_argument("--rank-only", action="store_true",
                    help="build, run the ranking phase (3f: lambdarank at "
                    "full width, the lambda kernel against its twin, "
                    "rank_xendcg) and the objectives phase (3g) and print "
                    "only their summaries and the lambda kernel's row")
    ap.add_argument("--options-only", action="store_true",
                    help="build, run the options phase (3h: by-node "
                    "sampling, extra-trees, constraints, CEGB, forced "
                    "splits and GOSS compaction through the device tree "
                    "loop, their kernels against their twins, card vs "
                    "host) and print only its summary and node_inputs' "
                    "row")
    ap.add_argument("--monotone-only", action="store_true",
                    help="build, run the monotone phase (3i: intermediate "
                    "and advanced monotone constraints through the device "
                    "tree loop, DART and RF, their kernels against their "
                    "twins, card vs host) and print only its summary and "
                    "the monotone kernels' rows")
    ap.add_argument("--linear-dense-only", action="store_true",
                    help="build, run the linear and dense phase (3j: "
                    "linear trees with the Gram kernel, the dense builder "
                    "at 1023 and 255 bins through the device tree loop, "
                    "their kernels against their twins, card vs host) and "
                    "print only its summary and its kernels' rows")
    ap.add_argument("--api-online-only", action="store_true",
                    help="build, run the API and online phase (3k: cv, "
                    "LGBMClassifier, the reset_parameter schedule, refit, "
                    "pred_contrib, convert_model and a PredictServer that "
                    "trains from /ingest while serving) and print only its "
                    "summary and launch counts")
    ap.add_argument("--fleet-only", action="store_true",
                    help="build, run the fleet phase (3l: the raw walk "
                    "against its twin, a trainer and two replicas serving "
                    "and training, failover, snapshot compaction) and "
                    "print only its summary and the raw walk's row")
    ap.add_argument("--parallel-only", action="store_true",
                    help="build, run the distributed learners' phase (3m: "
                    "D = 2 and 4 ranks on the card, each mode against "
                    "serial, card vs host, a sharded load) and print only "
                    "its summary")
    ap.add_argument("--parallel-rank", nargs=3, metavar=("RANK", "WORLD",
                                                        "WORK"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--scan-commit-only", action="store_true",
                    help="build, train --trees fused chain trees and print "
                    "only the split scan's and the split commit's stamped "
                    "phases and the launch floor (scan_commit_breakdown)")
    ap.add_argument("--breakdown-only", action="store_true",
                    help="build, train --trees one-kernel trees and print "
                    "only B7's per-phase breakdown (b7_breakdown)")
    ap.add_argument("--profile-only", action="store_true",
                    help="build, and print only the profiled fused block "
                    "(profile_block) of the chain and of the one-kernel "
                    "split at phase 3d's sizes: ms, device ops, the "
                    "chain's former sibling ops and graph nodes a tree")
    ap.add_argument("--root", default=HERE,
                    help="with --profile-only: the checkout whose "
                    "lightgbm_tpu_torch is built and driven (to compare "
                    "two commits on one card, run each in turns)")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    if root != HERE and not args.profile_only:
        ap.error("--root is for --profile-only")

    if not os.path.isdir(os.path.join(root, "lightgbm_tpu_torch", "csrc")):
        print("chip_smoke: run from a checkout of the repository "
              "(lightgbm_tpu_torch/ not found in %s)" % root,
              file=sys.stderr)
        return 2
    import torch
    if args.parallel_rank:
        # one rank of phase 3m's group (the parent built the kernels)
        sys.path.insert(0, HERE)
        rank, world, work = args.parallel_rank
        return parallel_rank(int(rank), int(world), work)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible to torch", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    import lightgbm_tpu_torch as lgt
    if os.path.dirname(os.path.dirname(os.path.abspath(lgt.__file__))) \
            != root:
        print("chip_smoke: imported %s, not the one in %s"
              % (lgt.__file__, root), file=sys.stderr)
        return 2
    # importing the op modules registers their kernels
    from lightgbm_tpu_torch.linear import fit as linear_fit  # noqa: F401
    from lightgbm_tpu_torch.ops import (commit, forest,  # noqa: F401
                                        histogram, kernels, monotone, node,
                                        partition, rank, route, scan)

    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[dev.index] if len(smi) > dev.index else "unknown"
    log("torch %s cuda %s, %s" % (torch.__version__, torch.version.cuda,
                                  torch.cuda.get_device_name(dev)))
    t_start = time.perf_counter()

    log("== phase 1: build")
    beside = None
    if not args.parallel_rank and not any(
            v for k, v in vars(args).items() if k.endswith("_only")):
        # the full run: its seeded data is made while nvcc runs
        beside = make_beside({
            ("training_data",): (training_data, args.seed, args.train_rows,
                                 args.valid_rows),
            ("mslr_like", RANK_ROWS): (mslr_like, RANK_ROWS)})
    secs = kernels.build_all()
    if beside is not None:
        log("build: the full run's data made beside it in %.1f s"
            % beside())
    for k in kernels.KERNELS.values():
        lines = [ln for ln in k.build_log.splitlines()
                 if "registers" in ln or "spill" in ln or "smem" in ln]
        log("build %s: %.1f s %s" % (k.symbol, k.build_seconds,
                                     " | ".join(lines)))
    log("build: %d kernels in %.1f s" % (len(kernels.KERNELS), secs))
    from lightgbm_tpu_torch import io_native
    t0 = time.perf_counter()
    host = io_native.build_all()
    log("build: host libraries %s in %.1f s (0.0: already built)"
        % (", ".join("%s %.1f s" % kv for kv in host.items()),
           time.perf_counter() - t0))

    if args.file_only:
        data = training_data(args.seed, args.train_rows, args.valid_rows)
        summary, counts = phase_file(dev, data, args.leaves, card)
        print(json.dumps({"file": summary, "launches": counts}))
        log(card)
        return 0

    if args.rank_only:
        summary_rank, counts_rank, row, errs = phase_rank(dev, card,
                                                          seed=args.seed)
        objectives = phase_objectives(
            dev, training_data(args.seed, OBJECTIVE_ROWS, 0), card,
            seed=args.seed)
        for name, e in errs.items():
            log("check %s: max |diff| %.3g" % (name, e))
        row = {name: dict(launches=counts_rank[name], **bound_row(name, r))
               for name, r in row.items()}
        print(json.dumps({"rank": summary_rank, "objectives": objectives,
                          "kernels": row}, default=str))
        log(card)
        return 0

    if args.options_only:
        data = training_data(args.seed, args.train_rows, args.valid_rows)
        summary_opt, counts_opt, errs, opt_rows = phase_options(
            dev, data, card, leaves=args.leaves, seed=args.seed)
        for name, e in errs.items():
            log("check %s: max |diff| %.3g" % (name, e))
        extended = opt_rows.pop("extended")
        row = {name: dict(launches=sum(c.get(name, 0)
                                       for c in counts_opt.values()),
                          **bound_row(name, r))
               for name, r in opt_rows.items()}
        print(json.dumps({"options": summary_opt, "kernels": row,
                          "extended": extended}, default=str))
        log(card)
        return 0

    if args.monotone_only:
        data = training_data(args.seed, args.train_rows, args.valid_rows)
        summary_mono, counts_mono, errs, mono_rows = phase_monotone(
            dev, data, card, leaves=args.leaves, seed=args.seed)
        for name, e in errs.items():
            log("check %s: max |diff| %.3g" % (name, e))
        extended = mono_rows.pop("extended")
        row = {name: dict(launches=sum(c.get(name, 0)
                                       for c in counts_mono.values()),
                          **bound_row(name, r))
               for name, r in mono_rows.items()}
        print(json.dumps({"monotone": summary_mono, "kernels": row,
                          "extended": extended}, default=str))
        log(card)
        return 0

    if args.linear_dense_only:
        data = training_data(args.seed, args.train_rows, args.valid_rows)
        summary_ld, counts_ld, errs, ld_rows = phase_linear_dense(
            dev, data, card, leaves=args.leaves, seed=args.seed)
        for name, e in errs.items():
            log("check %s: max |diff| %.3g" % (name, e))
        row = {name: dict(launches=linear_dense_launches(counts_ld,
                                                         summary_ld)[name],
                          **bound_row(name, r))
               for name, r in ld_rows.items()}
        print(json.dumps({"linear_dense": summary_ld, "kernels": row},
                         default=str))
        log(card)
        return 0

    if args.api_online_only:
        data = training_data(args.seed, args.train_rows, args.valid_rows)
        summary_api, counts_api = phase_api_online(
            dev, data, card, leaves=args.leaves, host_rows=args.host_rows,
            seed=args.seed)
        print(json.dumps({"api_online": summary_api,
                          "launches": {k: nonzero(v)
                                       for k, v in counts_api.items()}},
                         default=str))
        log(card)
        return 0

    if args.rows_only:
        data = training_data(args.seed, args.train_rows, args.valid_rows)
        ds = build_datasets(dev, data, args.leaves, QUANT_PARAMS)
        bst, counts, summary = phase_train(dev, ds, args.trees, args.leaves,
                                           QUANT_PARAMS)
        check_quantized_model(bst, counts, summary, args)
        errs = {}
        rows = full_width_rows_kernels(bst, dev, errs)
        for name, e in errs.items():
            log("check %s: max |diff| %.3g" % (name, e))
        print(json.dumps({"rows_kernels": rows,
                          "kernel_ms_per_tree":
                              summary["kernel_ms_per_tree"],
                          "wall_per_tree_ms": summary["wall_per_tree_ms"],
                          "model_sha256": summary["model_sha256"]},
                         default=str))
        log(card)
        return 0

    if args.planes_route_only:
        data = training_data(args.seed, args.train_rows, args.valid_rows)
        ds = build_datasets(dev, data, args.leaves)
        bst, counts, summary = phase_train(dev, ds, args.trees, args.leaves)
        for name in ("partition_segment", "route_rows"):
            if counts.get(name, 0) <= 0:
                raise AssertionError("planes training never launched %s"
                                     % name)
        check_model_sha("planes", summary, args, PLANES_MODEL_SHA256)
        errs = {}
        planes = full_width_planes(bst, dev, errs)
        route = full_width_route(bst, ds[1].construct(), dev, errs)
        for name, e in errs.items():
            log("check %s: max |diff| %.3g" % (name, e))
        print(json.dumps({"partition_segment": planes, "route_rows": route,
                          "kernel_ms_per_tree":
                              summary["kernel_ms_per_tree"],
                          "wall_per_tree_ms": summary["wall_per_tree_ms"],
                          "launches": counts,
                          "model_sha256": summary["model_sha256"]}))
        log(card)
        return 0

    if args.forest_only:
        import numpy as np
        data = training_data(args.seed, args.train_rows, args.valid_rows)
        ds = build_datasets(dev, data, args.leaves, QUANT_PARAMS)
        bst, counts, summary = phase_train(dev, ds, args.trees, args.leaves,
                                           QUANT_PARAMS)
        check_quantized_model(bst, counts, summary, args)
        errs = phase_forest_kernels(dev,
                                    np.random.RandomState(args.seed + 17))
        rng = np.random.RandomState(args.seed + 7)     # phase 6's requests
        reqs = {n: higgs_like(rng, n) for n in REQUEST_ROWS}
        shapes = full_width_forest(bst, reqs, dev, errs, seed=args.seed)
        latency = serve_latency(bst, reqs)
        for name, e in errs.items():
            log("check %s: max |diff| %.3g" % (name, e))
        print(json.dumps({"forest_predict": shapes,
                          "serve_latency_ms": latency,
                          "model_sha256": summary["model_sha256"]}))
        log(card)
        return 0

    if args.fused_only:
        import numpy as np
        errs = phase_commit_kernel(dev, np.random.RandomState(args.seed + 23),
                                   modes=(False, True))
        errs.update(phase_one_kernel_header(
            dev, np.random.RandomState(args.seed + 29)))
        errs.update(phase_chain_kernels(
            dev, np.random.RandomState(args.seed + 37)))
        errs.update(phase_fold_kernels(
            dev, np.random.RandomState(args.seed + 41)))
        data = training_data(args.seed, args.train_rows, args.valid_rows)
        bst_k, counts_k, summary_k = phase_train(
            dev, build_datasets(dev, data, args.leaves, ONE_KERNEL_PARAMS),
            args.trees, args.leaves, ONE_KERNEL_PARAMS)
        check_model_sha("one-kernel", summary_k, args, ONE_KERNEL_MODEL_SHA256)
        summary_k["predict_auc"] = auc_np(data[3], bst_k.predict(data[2]))
        del bst_k
        bst_f, counts_f, summary_f, chain_rows = phase_fused(
            dev, data, args.trees, args.leaves, summary_k, args, card, errs)
        rows = full_width_commit(bst_f, dev, errs)
        del bst_f
        _, counts_m, summary_m, errs_m, cat_row = phase_mixed(
            dev, args.seed, card)
        errs.update(errs_m)
        for name, e in errs.items():
            log("check %s: max |diff| %.3g" % (name, e))
        print(json.dumps({"fused": summary_f, "split_commit": rows,
                          "chain": chain_rows, "mixed": summary_m,
                          "route_rows_cat": cat_row,
                          "per_iteration_wall_per_tree_ms":
                              summary_k["wall_per_tree_ms"],
                          "launches": counts_f}, default=str))
        log(card)
        return 0

    if args.fleet_only:
        data = training_data(args.seed, args.train_rows, args.valid_rows)
        summary_fleet, counts_fleet, raw_row, _ = phase_fleet(
            dev, data, card, trees=args.trees, leaves=args.leaves,
            seed=args.seed)
        raw_row["launches"] = raw_row.pop("launches_main_path")
        print(json.dumps({"fleet": summary_fleet,
                          "kernels": {"forest_raw": bound_row("forest_raw",
                                                              raw_row)},
                          "launches": nonzero(counts_fleet)}, default=str))
        log(card)
        return 0

    if args.parallel_only:
        data = training_data(args.seed, args.train_rows, args.valid_rows)
        summary_par = phase_parallel(dev, data, card, leaves=args.leaves,
                                     host_rows=args.host_rows)
        print(json.dumps({"parallel": summary_par}, default=str))
        log(card)
        return 0

    if args.scan_commit_only:
        import lightgbm_tpu_torch as lgt
        X, y, _, _ = training_data(args.seed, args.train_rows,
                                   args.valid_rows)
        params = train_params(dev, args.leaves, {})
        train = lgt.Dataset(X, label=y, params=params)
        train.construct()
        bst = lgt.train(params, train, args.trees)
        out = scan_commit_breakdown(bst, dev)
        out["card"] = card
        print(json.dumps({"scan_commit_breakdown": out}, default=str))
        log(card)
        return 0

    if args.profile_only:
        X, y, _, _ = training_data(args.seed, args.train_rows, 1000)
        out = {"root": root, "card": card}
        for tag, extra in (("chain", {}),
                           ("one_kernel", ONE_KERNEL_PARAMS)):
            params = train_params(dev, args.leaves, extra)
            train = lgt.Dataset(X, label=y, params=params)
            train.construct()
            out[tag] = profile_block(dev, train, args.leaves, extra)
        print(json.dumps({"profile": out}, default=str))
        log(card)
        return 0

    if args.breakdown_only:
        data = training_data(args.seed, args.train_rows, args.valid_rows)
        ds = build_datasets(dev, data, args.leaves, RESIDENT_PARAMS)
        bst = phase_train(dev, ds, args.trees, args.leaves,
                          RESIDENT_PARAMS)[0]
        print(json.dumps({"b7_breakdown": b7_breakdown(bst, dev)}))
        log(card)
        return 0

    start_host_pool()
    log("== phase 2: kernels vs plain")
    import numpy as np
    errs = phase_kernels(dev, args.seed)
    errs.update(phase_one_kernel(dev, np.random.RandomState(args.seed + 3)))
    errs.update(phase_resident_kernels(dev,
                                       np.random.RandomState(args.seed + 5)))
    errs.update(phase_planes_route_kernels(
        dev, np.random.RandomState(args.seed + 11)))
    errs.update(phase_forest_kernels(dev,
                                     np.random.RandomState(args.seed + 17)))
    errs.update(phase_commit_kernel(dev,
                                    np.random.RandomState(args.seed + 23),
                                    modes=(False, True)))
    errs.update(phase_one_kernel_header(
        dev, np.random.RandomState(args.seed + 29)))
    errs.update(phase_chain_kernels(dev,
                                    np.random.RandomState(args.seed + 37)))
    errs.update(phase_fold_kernels(dev,
                                   np.random.RandomState(args.seed + 41)))
    for name, e in errs.items():
        log("check %s: max |diff| %.3g" % (name, e))

    log("== phase 2b: native construction at full size, and CSV files "
        "through the command line (%s)" % card)
    data = premade(("training_data",), training_data, args.seed,
                   args.train_rows, args.valid_rows)
    summary_file, counts_file = phase_file(dev, data, args.leaves, card)

    log("== phase 3: full-width training, planes layout (%s)" % card)
    planes_ds = build_datasets(dev, data, args.leaves)
    bst_p, counts_p, summary_p = phase_train(dev, planes_ds, args.trees,
                                             args.leaves)
    for name in ("partition_segment", "segment_histogram", "route_rows"):
        if counts_p.get(name, 0) <= 0:
            raise AssertionError("planes training never launched %s" % name)
    check_model_sha("planes", summary_p, args, PLANES_MODEL_SHA256)
    rows = full_width_segment_kernels(bst_p, dev, errs)
    rows["partition_segment"]["segments"] = full_width_planes(bst_p, dev,
                                                              errs)
    route_shapes = full_width_route(bst_p, planes_ds[1].construct(), dev,
                                    errs)
    check_determinism(dev, planes_ds[0], args.leaves)
    summary_p["profile"] = profile_iteration(dev, planes_ds[0], args.leaves)
    summary_p["card_vs_host"] = card_vs_host(dev, data, args.host_rows,
                                             args.leaves)
    rows.update(full_width_one_kernel(bst_p, dev, errs))

    log("== phase 3b: full-width training, one kernel per split (%s)" % card)
    bst_k, counts_k, summary_k = phase_one_kernel_train(
        dev, data, args.trees, args.leaves, summary_p, args.host_rows)
    check_model_sha("one-kernel", summary_k, args, ONE_KERNEL_MODEL_SHA256)
    summary_k["predict_auc"] = auc_np(data[3], bst_k.predict(data[2]))

    log("== phase 3c: full-width training, resident layout, one kernel "
        "per split (%s)" % card)
    bst_r, counts_rs, summary_rs = phase_resident_train(
        dev, data, args.trees, args.leaves, (bst_k, summary_k),
        args.host_rows)
    del bst_k
    rows.update(full_width_resident(bst_r, dev, errs))
    breakdown = b7_breakdown(bst_r, dev)
    cluster_probe(dev)
    for tag, mode, name in (("root", "planes", "one_kernel_split"),
                            ("root", "resident", "one_kernel_split_resident"),
                            ("deep", "resident", "one_kernel_split_resident")):
        rows[name]["%sstamps_ms" % ("deep_" if tag == "deep" else "")] = \
            breakdown[tag][mode][0]
    del bst_r

    log("== phase 3d: full-width training in fused blocks, the device tree "
        "loop as one CUDA graph per tree (%s)" % card)
    bst_f, counts_f, summary_f, chain_rows = phase_fused(
        dev, data, args.trees, args.leaves, summary_k, args, card, errs)
    rows.update(full_width_commit(bst_f, dev, errs))
    rows.update(chain_rows)
    del bst_f

    log("== phase 3e: categorical and EFB data through the device tree "
        "loop, fused against per iteration (%s)" % card)
    _, counts_m, summary_m, errs_m, cat_row = phase_mixed(dev, args.seed,
                                                          card)
    errs.update(errs_m)
    rows.update(cat_row)

    log("== phase 3f: ranking at full width: lambdarank through the "
        "lambda kernel and the device tree loop, rank_xendcg (%s)" % card)
    summary_rank, counts_rank, rank_row, errs_rank = phase_rank(
        dev, card, seed=args.seed)
    errs.update(errs_rank)
    rows.update(rank_row)

    log("== phase 3g: every other objective, card vs host (%s)"
        % card)
    summary_obj = phase_objectives(dev, data, card, seed=args.seed)

    log("== phase 3h: by-node sampling, extra-trees, interaction "
        "constraints, CEGB, forced splits and GOSS compaction through the "
        "device tree loop (%s)" % card)
    summary_opt, counts_opt, errs_opt, opt_rows = phase_options(
        dev, data, card, leaves=args.leaves, seed=args.seed)
    errs.update(errs_opt)
    extended = opt_rows.pop("extended")
    rows.update(opt_rows)
    for name in ("split_scan", "split_commit"):
        rows[name]["options"] = extended[name]
    log("phase 3h wall a tree beside phase 3d's (%s): %s; 3d three-launch "
        "%.1f, one-kernel planes %.1f ms"
        % (card, ", ".join("%s %.1f" % (k, v["wall_per_tree_ms"])
                           for k, v in summary_opt.items()),
           summary_f["three_launch"]["wall_per_tree_ms"],
           summary_f["planes"]["wall_per_tree_ms"]))

    log("== phase 3i: intermediate and advanced monotone constraints "
        "through the device tree loop, DART and RF (%s)" % card)
    summary_mono, counts_mono, errs_mono, mono_rows = phase_monotone(
        dev, data, card, leaves=args.leaves, seed=args.seed)
    errs.update(errs_mono)
    extended = mono_rows.pop("extended")
    rows.update(mono_rows)
    for name in ("split_scan", "split_commit"):
        rows[name]["monotone"] = extended[name]
    log("phase 3i wall a tree beside phase 3d's (%s): %s; steady %s; 3d "
        "three-launch %.1f ms"
        % (card, ", ".join("%s %.1f" % (k, v["wall_per_tree_ms"])
                           for k, v in summary_mono.items()),
           ", ".join("%s %.1f" % (k, v["steady_wall_per_tree_ms"])
                     for k, v in summary_mono.items()
                     if "steady_wall_per_tree_ms" in v),
           summary_f["three_launch"]["wall_per_tree_ms"]))

    log("== phase 3j: linear trees and the dense builder past 256 bins "
        "(%s)" % card)
    summary_ld, counts_ld, errs_ld, ld_rows = phase_linear_dense(
        dev, data, card, leaves=args.leaves, seed=args.seed)
    errs.update(errs_ld)
    rows.update(ld_rows)

    log("== phase 3k: the API surface (cv, LGBMClassifier, "
        "reset_parameter, refit, pred_contrib, convert_model) and online "
        "training behind /ingest while serving (%s)" % card)
    summary_api, counts_api = phase_api_online(
        dev, data, card, leaves=args.leaves, host_rows=args.host_rows,
        seed=args.seed)

    log("== phase 3l: the fleet on the card: the raw-threshold walk, a "
        "trainer and two replicas serving and training, failover and "
        "snapshot compaction (%s)" % card)
    summary_fleet, counts_fleet, raw_row, errs_fleet = phase_fleet(
        dev, data, card, trees=args.trees, leaves=args.leaves,
        seed=args.seed)
    errs.update(errs_fleet)
    raw_row.pop("launches_main_path")
    rows["forest_raw"] = raw_row

    log("== phase 3m: the distributed learners (data, feature, voting) on "
        "rank groups of 2 and 4 sharing the card, and a sharded load (%s)"
        % card)
    summary_par = phase_parallel(dev, data, card, leaves=args.leaves,
                                 host_rows=args.host_rows, serial=summary_p
                                 if args.trees >= PARALLEL_TREES else None)

    log("== phase 4: full-width quantized, sampled training (%s)" % card)
    quant_ds = build_datasets(dev, data, args.leaves, QUANT_PARAMS)
    bst_q, counts_q, summary_q = phase_train(dev, quant_ds, args.trees,
                                             args.leaves, QUANT_PARAMS)
    check_quantized_model(bst_q, counts_q, summary_q, args)
    rows.update(full_width_rows_kernels(bst_q, dev, errs))
    check_determinism(dev, quant_ds[0], args.leaves, extra=QUANT_PARAMS)
    summary_q["profile"] = profile_iteration(dev, quant_ds[0], args.leaves,
                                             QUANT_PARAMS)
    summary_q["card_vs_host"] = card_vs_host(
        dev, data, args.host_rows, args.leaves, extra=QUANT_PARAMS,
        first_tree_equal=True)
    gap = abs(summary_q["valid_auc"] - summary_p["valid_auc"])
    log("valid auc after %d trees: planes %.5f, quantized and sampled %.5f "
        "(|diff| %.5f, limit %.2f)" % (args.trees, summary_p["valid_auc"],
                                       summary_q["valid_auc"], gap, AUC_TOL))
    if gap > AUC_TOL:
        raise AssertionError("quantized valid auc %.5f vs planes %.5f"
                             % (summary_q["valid_auc"],
                                summary_p["valid_auc"]))

    log("== phase 5: rows layout and GOSS, short runs (%s)" % card)
    counts_r = rows_vs_planes(dev, data, args.host_rows, args.leaves)
    summary_q["goss_card_vs_host"] = card_vs_host(
        dev, data, args.host_rows, args.leaves, iters=4, extra=GOSS_PARAMS)

    log("== phase 6: serving the quantized model")
    rng = np.random.RandomState(args.seed + 7)
    g = bst_q.inner
    log("model: %d trees x %d leaves, %d features, device %s"
        % (len(g.models), args.leaves, g.train_set.num_total_features,
           g.device))
    # the request latency before the batcher, the server and the checks
    # run (serve_latency again below, after them)
    early_rng = np.random.RandomState(args.seed + 19)
    early = serve_latency(bst_q, {n: higgs_like(early_rng, n)
                                  for n in REQUEST_ROWS})
    out, serve_counts = phase_serve(bst_q, quant_ds[0], rng,
                                    args.binned_rows)
    for name in ("forest_predict", "route_rows"):
        if serve_counts.get(name, 0) <= 0:
            raise AssertionError("serving never launched %s" % name)
    serve_errs = check_serve(bst_q, out)
    for name, e in serve_errs.items():
        log("check %s: max |diff| %.3g" % (name, e))
    forest_shapes = full_width_forest(bst_q, out["reqs"], dev, errs,
                                      seed=args.seed)
    for tag, _ in FOREST_SHAPES:
        log("check forest/full_width_%s: max |diff| %.3g"
            % (tag, errs["forest/full_width_" + tag]))
    latency = serve_latency(bst_q, out["reqs"])

    log("host runs: the last collected after %.1f s more"
        % await_host_checks())
    stop_host_pool()

    log("== phase 7: timings (%s)" % card)
    rows = phase_timings(bst_q, out, dev, errs, rows, forest_shapes)
    rows["route_rows"]["shapes"] = route_shapes
    rows["forest_predict"]["serve_latency_ms"] = latency
    rows["forest_predict"]["serve_latency_ms_before_serving"] = early
    launches = {"partition_segment": counts_p["partition_segment"],
                "segment_histogram": counts_p["segment_histogram"],
                "partition_segment_rows": counts_q["partition_segment_rows"],
                "segment_histogram_q": counts_q["segment_histogram_q"],
                "segment_histogram_rows": counts_r["segment_histogram_rows"],
                "route_rows": counts_p["route_rows"] + counts_q["route_rows"]
                + serve_counts["route_rows"],
                "forest_predict": serve_counts["forest_predict"],
                "one_kernel_split": counts_k["one_kernel_split"],
                "one_kernel_split_resident":
                    counts_rs["one_kernel_split_resident"],
                "segment_histogram_resident":
                    counts_rs["segment_histogram_resident"],
                "write_route_plane":
                    summary_rs["three_launch"]["write_route_plane"],
                "split_commit": counts_f["planes"]["split_commit"]
                + sum(c.get("split_commit", 0) for c in counts_opt.values())
                + sum(c.get("split_commit", 0)
                      for c in counts_mono.values())
                + sum(counts_ld[k].get("split_commit", 0)
                      for k in DENSE_CONFIGS),
                "split_scan": counts_f["three_launch"]["split_scan"]
                + counts_f["quantized"]["split_scan"]
                + counts_m["split_scan"]
                + sum(c.get("split_scan", 0) for c in counts_opt.values())
                + sum(c.get("split_scan", 0) for c in counts_mono.values())
                + counts_ld["dense_255"].get("split_scan", 0),
                "mono_bounds": sum(c.get("mono_bounds", 0)
                                   for c in counts_mono.values()),
                "mono_commit": sum(c.get("mono_commit", 0)
                                   for c in counts_mono.values()),
                "node_inputs": sum(c.get("node_inputs", 0)
                                   for c in counts_opt.values()),
                "route_rows_cat": counts_m["route_rows_cat"],
                "rank_lambdas": counts_rank["rank_lambdas"],
                "forest_raw": counts_fleet["forest_raw"],
                **linear_dense_launches(counts_ld, summary_ld)}
    # phase 3k's parts run the main path's kernels too
    for name in launches:
        launches[name] += sum(c.get(name, 0) for c in counts_api.values())
    log("launches: planes training %s; one-kernel training %s; resident "
        "training %s; quantized training %s; rows run %s; serving %s"
        % (counts_p, counts_k, counts_rs, counts_q, counts_r, serve_counts))
    log("train summary planes %s" % json.dumps(summary_p))
    log("train summary one-kernel %s" % json.dumps(summary_k))
    log("train summary resident %s" % json.dumps(summary_rs))
    log("train summary quantized %s" % json.dumps(summary_q))
    log("train summary fused %s" % json.dumps(summary_f, default=str))
    log("train summary mixed %s" % json.dumps(summary_m, default=str))
    log("train summary rank %s" % json.dumps(summary_rank, default=str))
    log("train summary objectives %s" % json.dumps(summary_obj))
    log("train summary options %s" % json.dumps(summary_opt, default=str))
    log("train summary monotone %s" % json.dumps(summary_mono, default=str))
    log("train summary linear and dense %s" % json.dumps(summary_ld,
                                                          default=str))
    log("api and online summary %s; launches %s"
        % (json.dumps(summary_api, default=str),
           {k: nonzero(v) for k, v in counts_api.items()}))
    log("fleet summary %s; launches %s"
        % (json.dumps(summary_fleet, default=str), nonzero(counts_fleet)))
    log("parallel summary %s" % json.dumps(summary_par, default=str))
    log("file summary %s; launches %s" % (json.dumps(summary_file),
                                          counts_file))
    kernels_line = {"kernels": [dict(name=name, launches=launches[name], **r)
                                for name, r in rows.items()]}
    log(card)
    log("total %.1f s" % (time.perf_counter() - t_start))
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
