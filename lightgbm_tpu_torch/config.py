"""Configuration system: LightGBM-compatible parameter names, aliases, defaults.

The port's own copy of ``lightgbm_tpu/config.py``, so that parameter names,
aliases and defaults match the JAX package's. Re-design of the reference config (include/LightGBM/config.h:27-855,
src/io/config.cpp:15-279, src/io/config_auto.cpp). The reference generates its
setters from docs/Parameters.rst; here a single table of (name, type, default,
aliases) drives parsing, alias resolution and validation. LightGBM parameter
names are a de-facto standard, so the Python API accepts any alias the
reference accepts (config.h:857-865 ParameterAlias::KeyAliasTransform).
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Tuple

from .log import Log, LightGBMError

# (canonical_name, python_type, default, [aliases])
# Mirrors config.h params; list type uses comma-separated parsing like the
# reference's Common::StringToArray.
_PARAMS: List[Tuple[str, type, Any, List[str]]] = [
    # ---- core (config.h:100-240) ----
    ("config", str, "", ["config_file"]),
    ("task", str, "train", ["task_type"]),
    ("objective", str, "regression",
     ["objective_type", "app", "application", "loss"]),
    ("boosting", str, "gbdt", ["boosting_type", "boost"]),
    ("data", str, "", ["train", "train_data", "train_data_file", "data_filename"]),
    ("valid", list, [], ["test", "valid_data", "valid_data_file", "test_data",
                         "test_data_file", "valid_filenames"]),
    ("num_iterations", int, 100,
     ["num_iteration", "n_iter", "num_tree", "num_trees", "num_round",
      "num_rounds", "num_boost_round", "n_estimators", "max_iter"]),
    ("learning_rate", float, 0.1, ["shrinkage_rate", "eta"]),
    ("num_leaves", int, 31, ["num_leaf", "max_leaves", "max_leaf", "max_leaf_nodes"]),
    ("tree_learner", str, "serial", ["tree", "tree_type", "tree_learner_type"]),
    ("num_threads", int, 0,
     ["num_thread", "nthread", "nthreads", "n_jobs"]),
    ("device_type", str, "tpu", ["device"]),
    ("seed", int, 0, ["random_seed", "random_state"]),
    # ---- learning control (config.h:241-470) ----
    ("max_depth", int, -1, []),
    ("min_data_in_leaf", int, 20, ["min_data_per_leaf", "min_data", "min_child_samples", "min_samples_leaf"]),
    ("min_sum_hessian_in_leaf", float, 1e-3,
     ["min_sum_hessian_per_leaf", "min_sum_hessian", "min_hessian", "min_child_weight"]),
    ("bagging_fraction", float, 1.0, ["sub_row", "subsample", "bagging"]),
    ("bagging_freq", int, 0, ["subsample_freq"]),
    ("bagging_seed", int, 3, ["bagging_fraction_seed"]),
    ("feature_fraction", float, 1.0, ["sub_feature", "colsample_bytree"]),
    ("feature_fraction_seed", int, 2, []),
    ("early_stopping_round", int, 0,
     ["early_stopping_rounds", "early_stopping", "n_iter_no_change"]),
    ("first_metric_only", bool, False, []),
    ("max_delta_step", float, 0.0, ["max_tree_output", "max_leaf_output"]),
    ("lambda_l1", float, 0.0, ["reg_alpha", "l1_regularization"]),
    ("lambda_l2", float, 0.0, ["reg_lambda", "lambda", "l2_regularization"]),
    ("min_gain_to_split", float, 0.0, ["min_split_gain"]),
    # DART (config.h:300-340)
    ("drop_rate", float, 0.1, ["rate_drop"]),
    ("max_drop", int, 50, []),
    ("skip_drop", float, 0.5, []),
    ("xgboost_dart_mode", bool, False, []),
    ("uniform_drop", bool, False, []),
    ("drop_seed", int, 4, []),
    # GOSS
    ("top_rate", float, 0.2, []),
    ("other_rate", float, 0.1, []),
    # categorical
    ("min_data_per_group", int, 100, []),
    ("max_cat_threshold", int, 32, []),
    ("cat_l2", float, 10.0, []),
    ("cat_smooth", float, 10.0, []),
    ("max_cat_to_onehot", int, 4, []),
    # voting-parallel candidate count (config.h:349 top_k; PV-Tree,
    # voting_parallel_tree_learner.cpp): with tree_learner=voting each
    # device nominates its local top_k features per frontier slot and
    # only the <= 2*top_k vote-elected features' histogram columns are
    # exchanged per wave — comm O(2*top_k*B) instead of O(F*B). Larger is
    # more accurate (top_k >= num_features degenerates to the exact
    # data-parallel search), smaller is cheaper. Must be >= 1.
    ("top_k", int, 20, ["topk"]),
    ("monotone_constraints", list, [], ["mc", "monotone_constraint"]),
    ("feature_contri", list, [], ["feature_contrib", "fc", "fp", "feature_penalty"]),
    ("forcedsplits_filename", str, "", ["fs", "forced_splits_filename",
                                        "forced_splits_file", "forced_splits"]),
    ("refit_decay_rate", float, 0.9, []),
    ("cegb_tradeoff", float, 1.0, []),
    ("cegb_penalty_split", float, 0.0, []),
    ("cegb_penalty_feature_lazy", list, [], []),
    ("cegb_penalty_feature_coupled", list, [], []),
    # ---- IO (config.h:400-600) ----
    ("verbosity", int, 1, ["verbose"]),
    ("max_bin", int, 255, []),
    ("min_data_in_bin", int, 3, []),
    ("bin_construct_sample_cnt", int, 200000, ["subsample_for_bin"]),
    ("histogram_pool_size", float, -1.0, ["hist_pool_size"]),
    ("data_random_seed", int, 1, ["data_seed"]),
    ("output_model", str, "LightGBM_model.txt", ["model_output", "model_out"]),
    ("snapshot_freq", int, -1, ["save_period"]),
    # preemption-safe checkpoints (lightgbm_tpu.checkpoint,
    # docs/Checkpointing.md): full-training-state snapshots + exact resume
    ("checkpoint_dir", str, "", ["checkpoint_directory", "checkpoint_path"]),
    ("checkpoint_period", int, 1, ["checkpoint_freq"]),
    ("checkpoint_keep", int, 3, ["checkpoint_keep_last_n"]),
    ("resume", str, "", ["resume_from", "resume_dir"]),
    ("input_model", str, "", ["model_input", "model_in"]),
    ("output_result", str, "LightGBM_predict_result.txt",
     ["predict_result", "prediction_result", "predict_name", "prediction_name",
      "pred_name", "name_pred"]),
    ("initscore_filename", str, "", ["init_score_filename", "init_score_file",
                                     "init_score", "input_init_score"]),
    ("valid_data_initscores", list, [], ["valid_data_init_scores",
                                         "valid_init_score_file", "valid_init_score"]),
    ("pre_partition", bool, False, ["is_pre_partition"]),
    ("enable_bundle", bool, True, ["is_enable_bundle", "bundle"]),
    # pack pairs of <=16-bin features into one stored column via joint
    # encoding (the Dense4bitsBin analog, dense_nbits_bin.hpp) — halves
    # both storage bytes and histogram columns for small-bin features
    ("enable_nbit_packing", bool, True, ["nbit_packing"]),
    ("max_conflict_rate", float, 0.0, []),
    ("is_enable_sparse", bool, True, ["is_sparse", "enable_sparse", "sparse"]),
    ("sparse_threshold", float, 0.8, []),
    ("use_missing", bool, True, []),
    ("zero_as_missing", bool, False, []),
    ("two_round", bool, False, ["two_round_loading", "use_two_round_loading"]),
    ("save_binary", bool, False, ["is_save_binary", "is_save_binary_file"]),
    ("header", bool, False, ["has_header"]),
    ("label_column", str, "", ["label"]),
    ("weight_column", str, "", ["weight"]),
    ("group_column", str, "", ["group", "group_id", "query_column", "query", "query_id"]),
    ("ignore_column", str, "", ["ignore_feature", "blacklist"]),
    ("categorical_feature", str, "", ["cat_feature", "categorical_column", "cat_column"]),
    ("predict_raw_score", bool, False, ["is_predict_raw_score", "predict_rawscore", "raw_score"]),
    ("predict_leaf_index", bool, False, ["is_predict_leaf_index", "leaf_index"]),
    ("predict_contrib", bool, False, ["is_predict_contrib", "contrib"]),
    ("num_iteration_predict", int, -1, []),
    ("pred_early_stop", bool, False, []),
    ("pred_early_stop_freq", int, 10, []),
    ("pred_early_stop_margin", float, 10.0, []),
    ("convert_model_language", str, "", []),
    ("convert_model", str, "gbdt_prediction.cpp", ["convert_model_file"]),
    # ---- objective (config.h:600-740) ----
    ("num_class", int, 1, ["num_classes"]),
    ("is_unbalance", bool, False, ["unbalance", "unbalanced_sets"]),
    ("scale_pos_weight", float, 1.0, []),
    ("sigmoid", float, 1.0, []),
    ("boost_from_average", bool, True, []),
    ("reg_sqrt", bool, False, []),
    ("alpha", float, 0.9, []),
    ("fair_c", float, 1.0, []),
    ("poisson_max_delta_step", float, 0.7, []),
    ("tweedie_variance_power", float, 1.5, []),
    ("max_position", int, 20, []),
    ("label_gain", list, [], []),
    # ---- metric (config.h:700-760) ----
    ("metric", list, [], ["metrics", "metric_types"]),
    ("metric_freq", int, 1, ["output_freq"]),
    ("is_provide_training_metric", bool, False,
     ["training_metric", "is_training_metric", "train_metric"]),
    ("eval_at", list, [1, 2, 3, 4, 5],
     ["ndcg_eval_at", "ndcg_at", "map_eval_at", "map_at"]),
    # ---- network (config.h:740-770) ----
    ("num_machines", int, 1, ["num_machine"]),
    ("local_listen_port", int, 12400, ["local_port", "port"]),
    ("time_out", int, 120, []),
    ("machine_list_filename", str, "", ["machine_list_file", "machine_list", "mlist"]),
    ("machines", str, "", ["workers", "nodes"]),
    # ---- device (config.h:770-790); gpu_* accepted for compat, unused on TPU ----
    ("gpu_platform_id", int, -1, []),
    ("gpu_device_id", int, -1, []),
    ("gpu_use_dp", bool, False, []),          # true -> f64 histogram accum
    #   (reference double-precision histograms, config.h:784; enables jax
    #   x64 mode — ~2x memory, slower on TPU, tightest reference parity)
    # ---- TPU-specific extensions (no reference counterpart) ----
    ("tpu_hist_dtype", str, "float32", []),   # histogram accumulation dtype
    # histogram kernel: auto (pallas on TPU, scatter on CPU) | pallas |
    # pallas_highest (full-f32 MXU contraction, ~2x cost) | matmul |
    # scatter | pallas_interpret; f64 mode routes off the f32-only pallas
    # — the GPUTreeLearner device-path dispatch analog (tree_learner.cpp:9-31)
    ("tpu_hist_impl", str, "auto", []),
    # device bin-matrix packing (core/binpack.py; docs/Performance.md
    # "Packed bins & fused wave"): none = uint8 [N,C] columns on device;
    # byte = the same 8-bit codes packed 4-per-int32 word (lane-friendly
    # unpack inside each histogram impl; bitwise-identical trees);
    # nibble = byte packing PLUS pair-coding every two <=16-bin features
    # into one joint 8-bit column (extends enable_nbit_packing's cap from
    # max_bin to 256) — halves stored columns, host->device transfer, and
    # histogram scatter traffic (>=1.5x costmodel bytes), trees
    # structure-identical to unpacked. auto = none in-memory on CPU,
    # byte for streamed ingest, nibble on TPU-shaped backends when every
    # candidate feature fits 16 bins (byte otherwise).
    ("tpu_bin_packing", str, "auto", ["bin_packing"]),
    ("tpu_donate_buffers", bool, True, []),   # donate score/state buffers under jit
    ("mesh_shape", list, [], []),             # e.g. [8] / [4,2]; empty = all devices on one axis
    # growth strategy: exact = reference leaf-wise best-first; batched =
    # split the top-tree_batch_splits frontier leaves per sequential step
    # (approximate best-first; amortizes TPU per-split latency — the same
    # accuracy stance as the reference GPU learner's documented deviations,
    # GPU-Performance.rst:132-139; core/grow_batched.py); frontier =
    # split EVERY positive-gain frontier leaf per step with ONE batched
    # histogram sweep per wave — O(depth) dataset sweeps per tree instead
    # of O(num_leaves) (core/grow_frontier.py).
    ("tree_growth", str, "exact", ["growth_mode", "tree_grow_mode"]),
    ("tree_batch_splits", int, 16, []),
    # frontier wave-width bucketing (core/grow_frontier.py): specialize
    # each wave at the smallest pow-2 slot count covering the live
    # frontier instead of always num_leaves - 1 — hist FLOPs and psum
    # payload track 2^depth on early waves, structure unchanged. false
    # pins every wave at the fixed maximum width (debug / A-B runs).
    ("tpu_frontier_bucketing", bool, True, ["frontier_bucketing"]),
    # frontier data-parallel reduce-scatter schedule (parallel/learners.py
    # DataRSLearner): replace the per-wave full-histogram psum with a
    # tiled psum_scatter over the feature axis + a small all_gather/argmax
    # election of packed best-split records — per-device wave comm and
    # hist-pool memory drop to ~1/P. Committed trees are identical to the
    # psum schedule (contiguous rank-ordered feature blocks preserve the
    # first-max tie-break). false restores the full-psum wave (debug /
    # A-B runs). Only applies to tree_learner=data + tree_growth=frontier.
    ("tpu_frontier_rs", bool, True, ["frontier_rs"]),
    # persistent XLA compilation cache (jax_compilation_cache_dir):
    # compiled executables are written here and reloaded by later
    # processes, so warm starts skip backend compilation entirely —
    # profiling.enable_compile_cache wires it before the first compile
    # and counts hits/misses. Empty = off (jax default).
    ("compile_cache_dir", str, "", ["compilation_cache_dir",
                                    "jax_compilation_cache_dir"]),
    # batched growth: pack active rows so dead row tiles skip the slot
    # kernel's compute (cost ~ split-leaf rows, not N); opt-in until
    # measured on chip
    ("tpu_batched_pack", bool, False, []),
    # partitioned batched growth (core/grow_batched_part.py): rows kept
    # physically grouped by leaf so per-step kernel cost tracks the
    # splitting leaves' rows. auto currently = off — the per-step row
    # permutation measured slower than the kernel savings on chip
    # (docs/Performance.md); true forces it on for experiments.
    ("tpu_batched_part", str, "auto", []),
    # out-of-core streamed training (lightgbm_tpu.stream;
    # docs/OutOfCore.md): > 0 caps the rows of each host-resident binned
    # chunk — the dataset is ingested two-round (sample-based bin
    # boundaries, per-chunk quantize) and trained with per-chunk wave
    # histograms summed before split finding (additive, so the grown
    # structure matches single-shot at the same boundaries). 0 = off
    # (whole dataset in one device allocation). Requires
    # tree_growth=frontier and boosting gbdt/goss; single device only.
    ("data_stream_chunk_rows", int, 0, ["stream_chunk_rows"]),
    # chunks kept in flight ahead of the sweep cursor: each is
    # jax.device_put BEFORE the previous chunk's histogram kernel needs
    # it, so host->device transfer overlaps device compute
    ("data_stream_prefetch", int, 2, ["stream_prefetch"]),
    # rows per chunk of the partitioned growth loops (core/partition.py).
    # 0 = auto: 4096 on TPU-shaped backends (measured round-4 winner:
    # most leaves are far smaller than the old 16384 default, whose
    # single-trip padded work dominated the per-split floor), 16384
    # elsewhere. Larger chunks measured strictly worse on chip (65536 ->
    # 0.59x, 262144 -> 0.22x the 16384 throughput).
    ("tpu_row_chunk", int, 0, []),
    # ---- serving (lightgbm_tpu.serving; task=serve) ----
    ("serve_host", str, "127.0.0.1", []),
    ("serve_port", int, 8080, []),            # 0 = OS-assigned (tests)
    ("serve_max_batch", int, 4096, []),       # padded-batch cap / chunk size
    ("serve_min_bucket", int, 16, []),        # smallest padded batch
    ("serve_deadline_ms", float, 2.0, []),    # micro-batch coalesce window
    ("serve_num_devices", int, 1, []),        # 0 = all local devices
    ("serve_stdin", bool, False, []),         # JSON-lines on stdin/stdout
    ("serve_warmup", bool, True, []),         # compile all buckets at boot
    ("serve_metrics_file", str, "", []),      # JSON-lines metrics sink
    ("serve_metrics_freq", float, 10.0, []),  # seconds between snapshots
    # serving hot path (serving/traversal.py): SoA traversal vs replay,
    # early-exit cascade, and int16 leaf-table quantization
    ("serving_backend", str, "traversal", ["serve_backend"]),
    ("serving_cascade_trees", int, 0, ["serve_cascade_trees"]),
    ("serving_cascade_margin", float, 10.0, ["serve_cascade_margin"]),
    ("serving_quantize_leaves", bool, False, ["serve_quantize_leaves"]),
    # ---- observability (obs/, boosting/gbdt.py) ----
    # none: no instrumentation (default). basic: train_many's blocks kept,
    # a span, an event and one health fetch a block. full: one iteration
    # at a time with a span, an event and a health fetch each, the
    # Perfetto window, device memory every iteration.
    ("observability", str, "none", ["obs", "observability_level"]),
    # JSON-lines event stream (spans, iterations, health); "" = off
    ("obs_event_file", str, "", ["obs_events", "observability_event_file"]),
    # training stats HTTP endpoint: -1 = off, 0 = OS-assigned port
    ("obs_stats_port", int, -1, ["obs_metrics_port"]),
    # torch.profiler capture (observability=full) written as a Chrome
    # trace: directory, first iteration and iteration count of the window
    ("obs_perfetto_dir", str, "", ["obs_trace_dir"]),
    ("obs_perfetto_start", int, 0, []),
    ("obs_perfetto_iters", int, 0, []),       # 0 = no capture
    # device-side anomaly response: auto = warn when observability is on,
    # else off; abort = checkpoint (checkpoint_dir) then raise
    ("health_monitor", str, "auto",
     ["health_monitor_action", "obs_health"]),
    # ---- distributed obs (obs/distributed.py) ----
    # cross-process metric federation + straggler detection: auto = armed
    # whenever observability is on across several processes (off on the
    # port's one process); on refuses (ROADMAP Queue 1 #13); off disables
    ("obs_distributed", str, "auto", []),
    # warn when max/median per-process block wall time crosses this
    # ratio (routed through HealthMonitor, warn-only); 0 disables
    ("obs_straggler_warn_skew", float, 2.0, ["straggler_warn_skew"]),
    # flight-recorder ring size: recent events kept in memory per process
    # and dumped to <obs_event_file>.<process>.crash.jsonl on HealthMonitor
    # abort, SIGTERM, or unhandled exception; 0 = off
    ("obs_flight_recorder", int, 512, ["obs_flight_recorder_size"]),
    # ---- model statistics & drift (obs/modelstats.py, obs/drift.py) ----
    # per-feature split-count/gain accumulators + leaf distributions,
    # streamed as lgbm_model_* metrics and model_iter events. On the
    # frontier grower this piggy-backs an accumulator on the wave loop
    # (zero extra collectives); off keeps the compiled training program
    # byte-identical to an uninstrumented build.
    ("obs_modelstats", bool, False, ["model_stats", "modelstats"]),
    # train/serve drift detection (serving side; needs a model with a
    # training data profile): warn-only HealthMonitor routing + on_drift
    # refit hooks fire when any feature's PSI crosses this threshold
    ("obs_drift_warn_psi", float, 0.25, ["drift_warn_psi"]),
    # decay factor of the served score-distribution sketch (per row)
    ("obs_drift_decay", float, 0.999, ["drift_decay"]),
    # rows observed before PSI warns are armed (early traffic is noise)
    ("obs_drift_min_rows", int, 256, ["drift_min_rows"]),
    # drift monitoring on the serving predict path; off = zero overhead
    ("serve_drift", bool, True, []),
    # ---- request-scoped tracing (obs/reqtrace.py) ----
    # span tree per admitted request / streamed training iteration,
    # emitted on the event stream with tail-based sampling; off (default)
    # is the shared no-op span — zero allocation on the hot path and the
    # compiled programs are byte-identical either way (host-side only)
    ("obs_trace", bool, False, ["request_trace", "reqtrace"]),
    # always keep traces at least this slow (ms); shed/error always kept
    ("obs_trace_slow_ms", float, 250.0, ["trace_slow_ms"]),
    # fraction of the remaining (fast, ok) traces kept, decided by a
    # deterministic hash of (seed, trace_id) in [0, 1]
    ("obs_trace_sample", float, 0.01, ["trace_sample"]),
    # ---- SLO burn-rate engine (obs/slo.py; /slo on both StatsServers) ----
    # serving latency objective: p-fraction of requests under this many
    # ms (objective = serve_slo_target); 0 = no latency SLO
    ("serve_slo_p99_ms", float, 0.0, ["slo_p99_ms"]),
    # good-fraction the latency SLO targets (0.99 => 1% error budget)
    ("serve_slo_target", float, 0.99, []),
    # availability objective: fraction of requests NOT errored/shed/timed
    # out (e.g. 0.999); 0 = no availability SLO
    ("serve_slo_availability", float, 0.0, ["slo_availability"]),
    # streamed-training throughput floor (rows/sec); 0 = no training SLO
    ("train_slo_rows_per_sec", float, 0.0, ["slo_rows_per_sec"]),
    # Google-SRE multi-window burn rates: fast window for responsiveness,
    # slow window to ride out blips; burning when BOTH exceed the warn
    # threshold (burn 1.0 = consuming exactly the error budget)
    ("slo_fast_window_s", float, 300.0, []),
    ("slo_slow_window_s", float, 3600.0, []),
    ("slo_burn_warn", float, 2.0, ["slo_burn_threshold"]),
    # seconds between background SLO evaluations (serving ticker)
    ("slo_tick_s", float, 5.0, []),
    # ---- resilience (lightgbm_tpu.resilience; docs/Resilience.md) ----
    # deterministic fault plan: comma list of kind@unit:match[:arg], e.g.
    # "kv_timeout@round:2,kill@iter:7,serve_error@req:50". Strictly
    # host-side; "" (default) = injection fully inert.
    ("fault_inject", str, "", ["fault_plan"]),
    ("fault_seed", int, 0, []),
    # supervised training: watchdog + auto-resume restart loop around the
    # boosting loop (needs checkpoint_dir for somewhere to resume from)
    ("supervise", bool, False, ["supervised"]),
    ("supervise_max_restarts", int, 3, ["max_restarts"]),
    ("supervise_backoff_s", float, 1.0, []),
    ("supervise_backoff_max_s", float, 60.0, []),
    # hung-dispatch watchdog deadline (seconds); 0 = no watchdog. The
    # FIRST deadline adds supervise_warmup_grace_s: the initial compile
    # is slow-but-alive and must not false-fire.
    ("supervise_hang_timeout_s", float, 0.0, ["hang_timeout_s"]),
    ("supervise_warmup_grace_s", float, 120.0, []),
    # heartbeat file touched every iteration for an external process-level
    # supervisor (tools/chaos_smoke.py); "" = off
    ("supervise_heartbeat_file", str, "", ["heartbeat_file"]),
    # KvHostComm robustness: bounded retry-with-backoff on transient
    # coordination-service set/get failures before surfacing
    ("kv_retries", int, 3, []),
    ("kv_retry_backoff_s", float, 0.25, []),
    # KV heartbeat leases for peer-death detection (multi-process): each
    # rank re-leases every period_s; a peer silent past lease_s is dead
    ("kv_heartbeat_period_s", float, 2.0, []),
    ("kv_heartbeat_lease_s", float, 10.0, []),
    # serving overload protection: bounded admission in ROWS (0 = no
    # bound), per-request deadline in ms (0 = none)
    ("serve_max_queue_rows", int, 0, []),
    ("serve_request_timeout_ms", float, 0.0, []),
    # consecutive dispatch failures that trip the serving circuit breaker
    # to 503+Retry-After (0 disables); cooldown before a half-open probe
    ("serve_breaker_failures", int, 5, ["serve_breaker_threshold"]),
    ("serve_breaker_cooldown_s", float, 5.0, []),
    # guarded hot-roll: score canary rows on a staged bundle (finite
    # outputs, traversal-vs-replay parity, optional latency cap) and
    # refuse the swap on failure, keeping the prior generation live
    ("serve_guard_hot_roll", bool, True, ["serve_guarded_roll"]),
    ("serve_canary_rows", int, 16, []),
    ("serve_roll_max_latency_ms", float, 0.0, []),   # 0 = no latency gate
    # structure-preserving refit (fleet/refit.py): device path for dense
    # inputs (host numpy fallback for sparse / when disabled)
    ("refit_device", bool, True, []),
    # multi-model QoS (fleet/qos.py): default per-model queued-row quota
    # (0 = engine-wide bound only) and "model=weight,..." weighted-fair
    # scheduling weights (empty = every model weight 1; QoS engages when
    # either is set)
    ("serve_qos_quota_rows", int, 0, []),
    ("serve_qos_weights", str, "", []),
    # cascade-margin autotuning: hold observed per-bucket p99 under this
    # budget by walking serving_cascade_margin down a geometric ladder
    # (0 = autotune off; needs serving_cascade_trees > 0)
    ("serve_latency_budget_ms", float, 0.0, []),
    ("serve_qos_tune_interval_s", float, 2.0, []),
    # serving fleet (fleet/replica.py): shared file-KV directory replicas
    # announce generations/state through, this process' replica name, and
    # the announce period (fleet engages when fleet_kv_dir is set)
    ("fleet_kv_dir", str, "", []),
    ("fleet_replica", str, "", []),
    ("fleet_announce_period_s", float, 1.0, []),
]

# known spellings, validated in _post_process (a typo'd kernel or growth
# mode must fail loudly at config time, not fall through to some default
# deep in the dispatch)
TREE_GROW_MODES = ("exact", "batched", "frontier")
SERVING_BACKENDS = ("traversal", "replay")
OBSERVABILITY_LEVELS = ("none", "basic", "full")
HEALTH_MONITOR_ACTIONS = ("auto", "none", "warn", "abort", "raise")
OBS_DISTRIBUTED_MODES = ("auto", "on", "off")
HIST_IMPLS = ("auto", "matmul", "scatter", "pallas", "pallas_highest",
              "pallas_interpret", "pallas_highest_interpret",
              # the port's plain PyTorch histogram (core/histogram.py)
              "plain")
BIN_PACKING_MODES = ("auto", "none", "nibble", "byte")

_CANON: Dict[str, Tuple[type, Any]] = {n: (t, d) for n, t, d, _ in _PARAMS}
_ALIASES: Dict[str, str] = {}
for _n, _t, _d, _al in _PARAMS:
    _ALIASES[_n] = _n
    for _a in _al:
        _ALIASES[_a] = _n

# Objective aliases (objective_function.cpp:14-42 & config_auto resolution).
_OBJECTIVE_ALIASES = {
    "regression": "regression", "regression_l2": "regression", "l2": "regression",
    "mean_squared_error": "regression", "mse": "regression", "l2_root": "regression",
    "root_mean_squared_error": "regression", "rmse": "regression",
    "regression_l1": "regression_l1", "l1": "regression_l1",
    "mean_absolute_error": "regression_l1", "mae": "regression_l1",
    "mean_absolute_percentage_error": "mape", "mape": "mape",
    "huber": "huber", "fair": "fair", "poisson": "poisson",
    "quantile": "quantile", "gamma": "gamma", "tweedie": "tweedie",
    "binary": "binary",
    "multiclass": "multiclass", "softmax": "multiclass",
    "multiclassova": "multiclassova", "multiclass_ova": "multiclassova",
    "ova": "multiclassova", "ovr": "multiclassova",
    "xentropy": "xentropy", "cross_entropy": "xentropy",
    "xentlambda": "xentlambda", "cross_entropy_lambda": "xentlambda",
    "lambdarank": "lambdarank", "rank_xendcg": "lambdarank",
    "none": "none", "null": "none", "custom": "none", "na": "none",
}

_BOOSTING_ALIASES = {
    "gbdt": "gbdt", "gbrt": "gbdt",
    "dart": "dart",
    "goss": "goss",
    "rf": "rf", "random_forest": "rf",
}

_TREE_LEARNER_ALIASES = {
    "serial": "serial",
    "feature": "feature", "feature_parallel": "feature",
    "data": "data", "data_parallel": "data",
    "voting": "voting", "voting_parallel": "voting",
}


def _coerce(name: str, typ: type, value: Any) -> Any:
    try:
        if typ is bool:
            if isinstance(value, str):
                return value.strip().lower() in ("true", "+", "1", "yes")
            return bool(value)
        if typ is int:
            return int(float(value)) if isinstance(value, str) else int(value)
        if typ is float:
            return float(value)
        if typ is list:
            if isinstance(value, str):
                value = [v for v in value.replace(" ", ",").split(",") if v != ""]
            if isinstance(value, (int, float)):
                value = [value]
            out = []
            for v in value:
                if isinstance(v, str):
                    try:
                        v = int(v)
                    except ValueError:
                        try:
                            v = float(v)
                        except ValueError:
                            pass
                out.append(v)
            return out
        if typ is str:
            return str(value)
    except (TypeError, ValueError) as err:
        raise LightGBMError("Parameter %s should be of type %s, got %r (%s)"
                            % (name, typ.__name__, value, err))
    return value


def param_dict_to_str(params: Optional[Dict[str, Any]]) -> str:
    """Serialize params to the ``k=v`` space-joined string the C API uses."""
    if not params:
        return ""
    pairs = []
    for k, v in params.items():
        if isinstance(v, (list, tuple)):
            pairs.append("%s=%s" % (k, ",".join(map(str, v))))
        elif v is not None:
            pairs.append("%s=%s" % (k, v))
    return " ".join(pairs)


class Config:
    """Typed parameter container (config.h:27 Config struct analog)."""

    def __init__(self, params: Optional[Dict[str, Any]] = None):
        for name, (_typ, default) in _CANON.items():
            setattr(self, name, copy.copy(default))
        self.extra_params: Dict[str, Any] = {}
        if params:
            self.set(params)

    @staticmethod
    def resolve_key(key: str) -> str:
        """ParameterAlias::KeyAliasTransform (config.h:857-865)."""
        return _ALIASES.get(key, key)

    def set(self, params: Dict[str, Any]) -> "Config":
        """Config::Set (config.cpp:153): alias resolve, coerce, validate."""
        resolved: Dict[str, Any] = {}
        for key, value in params.items():
            if value is None:
                continue
            canon = self.resolve_key(key)
            if canon in resolved and canon != key:
                Log.warning("%s is set with both %s and an alias; using %r",
                            canon, key, resolved[canon])
                continue
            resolved[canon] = value
        for key, value in resolved.items():
            if key in _CANON:
                typ, _ = _CANON[key]
                setattr(self, key, _coerce(key, typ, value))
            else:
                self.extra_params[key] = value
        self._post_process()
        return self

    def _post_process(self) -> None:
        obj = str(self.objective).strip().lower()
        if obj.startswith("quantile_l2"):
            obj = "quantile"
        if obj in ("l2_root", "root_mean_squared_error", "rmse"):
            self.reg_sqrt = True
        self.objective = _OBJECTIVE_ALIASES.get(obj, obj)
        self.boosting = _BOOSTING_ALIASES.get(str(self.boosting).strip().lower(),
                                              self.boosting)
        self.tree_learner = _TREE_LEARNER_ALIASES.get(
            str(self.tree_learner).strip().lower(), self.tree_learner)
        if self.tree_learner not in ("serial", "feature", "data", "voting"):
            raise LightGBMError("Unknown tree learner type %s" % self.tree_learner)
        if self.boosting not in ("gbdt", "dart", "goss", "rf"):
            raise LightGBMError("Unknown boosting type %s" % self.boosting)
        # derived: is_parallel (config.h:790)
        self.is_parallel = (self.tree_learner != "serial") or self.num_machines > 1
        if self.boosting == "rf":
            if not (self.bagging_freq > 0 and 0.0 < self.bagging_fraction < 1.0):
                raise LightGBMError(
                    "Random forest needs bagging_freq > 0 and bagging_fraction in (0, 1)")
        if self.boosting == "goss":
            if self.top_rate + self.other_rate > 1.0:
                raise LightGBMError("GOSS needs top_rate + other_rate <= 1.0")
        if not (0.0 < self.feature_fraction <= 1.0):
            raise LightGBMError("feature_fraction should be in (0, 1.0]")
        if not (0.0 < self.bagging_fraction <= 1.0):
            raise LightGBMError("bagging_fraction should be in (0, 1.0]")
        if not (1 < self.max_bin <= 256):
            raise LightGBMError("max_bin should be in (1, 256]")
        if self.num_leaves < 2:
            raise LightGBMError("num_leaves should be >= 2")
        self.tree_growth = str(self.tree_growth).strip().lower()
        if self.tree_growth not in TREE_GROW_MODES:
            raise LightGBMError("tree_growth should be one of %s, got %s"
                                % ("/".join(TREE_GROW_MODES),
                                   self.tree_growth))
        self.tpu_hist_impl = str(self.tpu_hist_impl).strip().lower()
        if self.tpu_hist_impl not in HIST_IMPLS:
            raise LightGBMError("tpu_hist_impl should be one of %s, got %s"
                                % ("/".join(HIST_IMPLS),
                                   self.tpu_hist_impl))
        self.tpu_bin_packing = str(self.tpu_bin_packing).strip().lower()
        if self.tpu_bin_packing not in BIN_PACKING_MODES:
            raise LightGBMError("tpu_bin_packing should be one of %s, got %s"
                                % ("/".join(BIN_PACKING_MODES),
                                   self.tpu_bin_packing))
        if self.tree_batch_splits < 1:
            raise LightGBMError("tree_batch_splits should be >= 1")
        self.tpu_batched_part = str(self.tpu_batched_part).strip().lower()
        if self.tpu_batched_part not in ("auto", "true", "false", "1", "0"):
            raise LightGBMError("tpu_batched_part should be auto, true or "
                                "false, got %s" % self.tpu_batched_part)
        if self.tpu_row_chunk < 0:
            raise LightGBMError("tpu_row_chunk should be >= 0 (0 = auto), "
                                "got %s" % self.tpu_row_chunk)
        if self.data_stream_chunk_rows < 0:
            raise LightGBMError("data_stream_chunk_rows should be >= 0 "
                                "(0 = off), got %s"
                                % self.data_stream_chunk_rows)
        if self.data_stream_prefetch < 1:
            raise LightGBMError("data_stream_prefetch should be >= 1, got %s"
                                % self.data_stream_prefetch)
        if self.data_stream_chunk_rows > 0:
            # the streamed trainer is the frontier grower driven from the
            # host; every incompatible combination fails HERE, at config
            # time, not deep inside the training dispatch
            if self.tree_growth != "frontier":
                raise LightGBMError(
                    "data_stream_chunk_rows requires tree_growth=frontier "
                    "(cross-chunk histogram accumulation rides the wave "
                    "sweep); got tree_growth=%s" % self.tree_growth)
            if self.boosting not in ("gbdt", "goss"):
                raise LightGBMError(
                    "data_stream_chunk_rows supports boosting gbdt/goss "
                    "only (dart/rf replay full binned data per iteration); "
                    "got boosting=%s" % self.boosting)
            # chunks x chips: a data-parallel mesh composes with the
            # chunk stream (each process sweeps its row shard and the
            # learner collectives fire once per wave); the remaining
            # unsupported combinations each fail here BY NAME
            if self.mesh_shape and self.tree_learner == "feature":
                raise LightGBMError(
                    "gate streamed+feature-learner: the chunk stream is "
                    "row-partitioned, so tree_learner=feature (column-"
                    "partitioned search) cannot ride it; use "
                    "tree_learner=data or voting with "
                    "data_stream_chunk_rows")
            if self.mesh_shape and self.gpu_use_dp:
                raise LightGBMError(
                    "gate streamed-mesh+f64: streamed mesh training "
                    "accumulates f32 wave histograms and the reduce-"
                    "scatter/voting schedules bitcast f32 records; unset "
                    "gpu_use_dp or data_stream_chunk_rows/mesh_shape")
            if self.gpu_use_dp:
                raise LightGBMError(
                    "data_stream_chunk_rows accumulates f32 wave "
                    "histograms; gpu_use_dp (f64) is not supported")
        if self.top_k < 1:
            raise LightGBMError("top_k should be >= 1 (voting-parallel "
                                "candidate count), got %s" % self.top_k)
        # a file where the cache DIRECTORY should be will corrupt silently
        # deep inside jax; fail at config time like the other path params
        if self.compile_cache_dir:
            import os
            if os.path.exists(self.compile_cache_dir) and \
                    not os.path.isdir(self.compile_cache_dir):
                raise LightGBMError(
                    "compile_cache_dir %s exists and is not a directory"
                    % self.compile_cache_dir)
        if self.checkpoint_period < 1:
            raise LightGBMError("checkpoint_period should be >= 1, got %s"
                                % self.checkpoint_period)
        if self.checkpoint_keep < 1:
            raise LightGBMError("checkpoint_keep should be >= 1, got %s"
                                % self.checkpoint_keep)
        self.observability = str(self.observability).strip().lower()
        if self.observability not in OBSERVABILITY_LEVELS:
            raise LightGBMError("observability should be one of %s, got %s"
                                % ("/".join(OBSERVABILITY_LEVELS),
                                   self.observability))
        self.health_monitor = str(self.health_monitor).strip().lower()
        if self.health_monitor not in HEALTH_MONITOR_ACTIONS:
            raise LightGBMError("health_monitor should be one of %s, got %s"
                                % ("/".join(HEALTH_MONITOR_ACTIONS),
                                   self.health_monitor))
        if not -1 <= self.obs_stats_port <= 65535:
            raise LightGBMError("obs_stats_port should be in [-1, 65535] "
                                "(-1 = off, 0 = OS-assigned), got %s"
                                % self.obs_stats_port)
        if self.obs_perfetto_start < 0 or self.obs_perfetto_iters < 0:
            raise LightGBMError("obs_perfetto_start/obs_perfetto_iters "
                                "should be >= 0")
        self.obs_distributed = str(self.obs_distributed).strip().lower()
        if self.obs_distributed not in OBS_DISTRIBUTED_MODES:
            raise LightGBMError("obs_distributed should be one of %s, "
                                "got %s"
                                % ("/".join(OBS_DISTRIBUTED_MODES),
                                   self.obs_distributed))
        if self.obs_straggler_warn_skew < 0:
            raise LightGBMError("obs_straggler_warn_skew should be >= 0 "
                                "(0 disables), got %s"
                                % self.obs_straggler_warn_skew)
        if self.obs_flight_recorder < 0:
            raise LightGBMError("obs_flight_recorder should be >= 0 "
                                "(0 = off), got %s"
                                % self.obs_flight_recorder)
        if self.obs_drift_warn_psi <= 0:
            raise LightGBMError("obs_drift_warn_psi should be > 0, got %s"
                                % self.obs_drift_warn_psi)
        if not 0.0 < self.obs_drift_decay <= 1.0:
            raise LightGBMError("obs_drift_decay should be in (0, 1], "
                                "got %s" % self.obs_drift_decay)
        if self.obs_drift_min_rows < 0:
            raise LightGBMError("obs_drift_min_rows should be >= 0, got %s"
                                % self.obs_drift_min_rows)
        if self.obs_trace_slow_ms < 0:
            raise LightGBMError("obs_trace_slow_ms should be >= 0, got %s"
                                % self.obs_trace_slow_ms)
        if not 0.0 <= self.obs_trace_sample <= 1.0:
            raise LightGBMError("obs_trace_sample should be in [0, 1], "
                                "got %s" % self.obs_trace_sample)
        if self.serve_slo_p99_ms < 0:
            raise LightGBMError("serve_slo_p99_ms should be >= 0 "
                                "(0 = no latency SLO), got %s"
                                % self.serve_slo_p99_ms)
        if not 0.0 < self.serve_slo_target < 1.0:
            raise LightGBMError("serve_slo_target should be in (0, 1), "
                                "got %s" % self.serve_slo_target)
        if not 0.0 <= self.serve_slo_availability < 1.0:
            raise LightGBMError("serve_slo_availability should be in "
                                "[0, 1) (0 = no availability SLO), got %s"
                                % self.serve_slo_availability)
        if self.train_slo_rows_per_sec < 0:
            raise LightGBMError("train_slo_rows_per_sec should be >= 0 "
                                "(0 = no training SLO), got %s"
                                % self.train_slo_rows_per_sec)
        if self.slo_fast_window_s <= 0 or self.slo_slow_window_s <= 0:
            raise LightGBMError(
                "slo_fast_window_s/slo_slow_window_s should be > 0")
        if self.slo_fast_window_s > self.slo_slow_window_s:
            raise LightGBMError("slo_fast_window_s (%s) should not exceed "
                                "slo_slow_window_s (%s)"
                                % (self.slo_fast_window_s,
                                   self.slo_slow_window_s))
        if self.slo_burn_warn <= 0:
            raise LightGBMError("slo_burn_warn should be > 0, got %s"
                                % self.slo_burn_warn)
        if self.slo_tick_s <= 0:
            raise LightGBMError("slo_tick_s should be > 0, got %s"
                                % self.slo_tick_s)
        self.serving_backend = str(self.serving_backend).strip().lower()
        if self.serving_backend not in SERVING_BACKENDS:
            raise LightGBMError("serving_backend should be one of %s, got %s"
                                % ("/".join(SERVING_BACKENDS),
                                   self.serving_backend))
        if self.serving_cascade_trees < 0:
            raise LightGBMError("serving_cascade_trees should be >= 0 "
                                "(0 = no cascade), got %s"
                                % self.serving_cascade_trees)
        if self.serving_cascade_margin < 0:
            raise LightGBMError("serving_cascade_margin should be >= 0, "
                                "got %s" % self.serving_cascade_margin)
        # fault plans parse here: a mistyped kind fails now, not by never
        # firing (a kv_* kind, whose seam the port lacks, refuses)
        if self.fault_inject:
            from .resilience import faults as _faults
            _faults.parse_plan(self.fault_inject, self.fault_seed)
        if self.supervise_max_restarts < 0:
            raise LightGBMError("supervise_max_restarts should be >= 0, "
                                "got %s" % self.supervise_max_restarts)
        if self.supervise_backoff_s < 0 or self.supervise_backoff_max_s < 0:
            raise LightGBMError(
                "supervise_backoff_s/supervise_backoff_max_s should be >= 0")
        if self.supervise_hang_timeout_s < 0 or \
                self.supervise_warmup_grace_s < 0:
            raise LightGBMError(
                "supervise_hang_timeout_s/supervise_warmup_grace_s should "
                "be >= 0 (0 = no watchdog)")
        if self.kv_retries < 0:
            raise LightGBMError("kv_retries should be >= 0, got %s"
                                % self.kv_retries)
        if self.kv_retry_backoff_s < 0:
            raise LightGBMError("kv_retry_backoff_s should be >= 0, got %s"
                                % self.kv_retry_backoff_s)
        if self.kv_heartbeat_period_s <= 0 or self.kv_heartbeat_lease_s <= 0:
            raise LightGBMError(
                "kv_heartbeat_period_s/kv_heartbeat_lease_s should be > 0")
        if self.serve_max_queue_rows < 0:
            raise LightGBMError("serve_max_queue_rows should be >= 0 "
                                "(0 = unbounded), got %s"
                                % self.serve_max_queue_rows)
        if self.serve_request_timeout_ms < 0:
            raise LightGBMError("serve_request_timeout_ms should be >= 0 "
                                "(0 = none), got %s"
                                % self.serve_request_timeout_ms)
        if self.serve_breaker_failures < 0:
            raise LightGBMError("serve_breaker_failures should be >= 0 "
                                "(0 disables), got %s"
                                % self.serve_breaker_failures)
        if self.serve_breaker_cooldown_s < 0:
            raise LightGBMError("serve_breaker_cooldown_s should be >= 0, "
                                "got %s" % self.serve_breaker_cooldown_s)
        if self.serve_canary_rows < 1:
            raise LightGBMError("serve_canary_rows should be >= 1, got %s"
                                % self.serve_canary_rows)
        if self.serve_roll_max_latency_ms < 0:
            raise LightGBMError("serve_roll_max_latency_ms should be >= 0 "
                                "(0 = no latency gate), got %s"
                                % self.serve_roll_max_latency_ms)
        if self.serve_qos_quota_rows < 0:
            raise LightGBMError("serve_qos_quota_rows should be >= 0 "
                                "(0 = engine-wide bound only), got %s"
                                % self.serve_qos_quota_rows)
        if self.serve_latency_budget_ms < 0:
            raise LightGBMError("serve_latency_budget_ms should be >= 0 "
                                "(0 = autotune off), got %s"
                                % self.serve_latency_budget_ms)
        if self.serve_latency_budget_ms > 0 and \
                self.serving_cascade_trees <= 0:
            raise LightGBMError(
                "serve_latency_budget_ms needs serving_cascade_trees > 0 "
                "(there is no early-exit cascade to autotune)")
        if self.serve_qos_tune_interval_s <= 0:
            raise LightGBMError("serve_qos_tune_interval_s should be > 0, "
                                "got %s" % self.serve_qos_tune_interval_s)
        if self.fleet_announce_period_s <= 0:
            raise LightGBMError("fleet_announce_period_s should be > 0, "
                                "got %s" % self.fleet_announce_period_s)
        # verbosity drives the process logger unconditionally so
        # verbosity=-1 (fatal-only) also silences obs warnings; previously
        # negative values were dropped and warnings leaked through
        Log.reset_level(self.verbosity)

    def copy(self) -> "Config":
        return copy.deepcopy(self)

    def to_dict(self) -> Dict[str, Any]:
        d = {name: getattr(self, name) for name in _CANON}
        d.update(self.extra_params)
        return d

    def __repr__(self) -> str:  # pragma: no cover
        return "Config(%r)" % (self.to_dict(),)

