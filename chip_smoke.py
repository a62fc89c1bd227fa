#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lightgbm_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build every CUDA kernel of the port from the sources in this checkout,
   one nvcc per library, all started together;
3. hold each kernel against its plain PyTorch version on the card at the
   main paths' shapes, and time kernel, plain version, the one-call
   library yardstick and the memory bound: the histogram kernel
   (histogram.cu), both of its variants, at the root and at five split
   shapes of exact growth (512 to 262,144 rows), with the profiler's
   device time beside the event-timed one and an exact count channel,
   the slot kernel (hist_slots.cu, K=3) at 1,000,000 x 28 x 255 bins with
   half the rows active at S = 2, 16, 128 and 254 slots and its K=6
   parent-slot variant at S = 16, each with the profiler's device time by
   launch, the wrapper's host time and an exact count channel, the
   partitioned-layout kernel (hist_part.cu) on the
   layout of 1,000,000 rows at 255 leaves (745 tiles of 2,048 rows) at the
   four shapes of a 255-leaf tree's steps (PART_SHAPES: S = 1 and 16 with
   every row-holding tile active, S = 16 with a half and an eighth of
   them), each with the profiler's device time by launch, the wrapper's
   host time and an exact count channel, and the in-tile
   partition (repack.cu) at 1,048,576 x 128 bytes, 512-row tiles, 30% of
   the rows going left, which must come back byte-equal; the rebuild of
   one leaf for a forced split (``hist_for_leaf``: histogram.cu through
   its own wrapper, K=3) at 1,000,000 rows, a leaf of 4,096 and one of
   262,144 rows gathered with its sibling's (LEAF_SHAPES), its count
   channel exact; histogram.cu's float64 variant (``gpu_use_dp``) at the
   root (1,000,000 x 28, K=3) and at split passes of 4,096 and 262,144 rows
   (K=6), both variants forced at each, and through ``hist_for_leaf`` at
   LEAF_SHAPES, held to the plain version in float64 (the count channel
   exact, the others within 1e-12 * sum_bin|v| + 1e-300) and timed
   against its bound (float64 additions at 34 TFLOP/s) and one float64
   ``index_add_``; the packed-word variants of histogram.cu and
   hist_slots.cu (``tpu_bin_packing``, int32 words of four codes read in
   place at a row stride of 4 W bytes) at WORD_HIST_SHAPES and
   WORD_SLOT_SHAPES, held to their plain versions (the words unpacked) and
   timed beside the uint8 variants on the same codes, one ``index_add_``
   and their bound (the words' bytes); and one bagging
   draw of 1,000,000 threefry uniforms (``random.py``, torch ops), timed
   and held bit-equal to the same draw on the CPU;
4. the main paths at full width, one per growth mode: bench.py's workload
   (1,000,000 x 28, numpy seed 0), objective=binary, num_leaves=255,
   max_bin=255, through ``lightgbm_tpu_torch.train`` for 5 iterations on
   CUDA and ``Booster.predict`` on the same rows:
     4a ``tree_growth=exact`` (the histogram kernel),
     4b ``tree_growth=frontier`` (the slot kernel, one launch per wave),
     4c ``tree_growth=batched``, ``tree_batch_splits=16`` (the K=6 slot
        kernel, one launch per step),
     4d the same with ``tpu_batched_part=true`` (the partitioned-layout
        kernel, one launch per step);
   every kernel's launch count is reset just before each path and read
   just after, each path must launch its kernels, and its train AUC is
   held against the JAX package's on the same data and parameters;
   then the regression paths, one per growth mode, on the same features
   with bench.py's target before its threshold (``x0 + x1*x2 +
   0.5*sin(3*x3) + 0.3*noise``) and the same parameters:
     4e ``exact``, ``objective=regression``, with a validation set of
        250,000 rows drawn the same way from seed 1, early stopping after
        5 rounds and ``evals_result``,
     4f ``frontier``, ``huber``,
     4g ``batched`` (K=16), ``quantile`` with ``alpha=0.9`` (leaf
        renewal),
     4h ``batched_part`` (K=16), ``regression_l1`` (leaf renewal);
   each path's train metric, and 4e's valid l2 at every iteration, are
   held within 1e-3 relative of the JAX package's, and 4e's valid scores
   held on the card against ``predict(x_valid, raw_score=True)`` within
   1e-5; each path reports its seconds per iteration and the event-timed
   ms per iteration of renewal (4g, 4h) or of the valid-set update (4e),
   and renewal alone is timed at 1,000,000 rows and 255 leaves;
   then the bundled paths, binary with default ``enable_bundle`` and
   ``enable_nbit_packing``, on HIGGS-shaped data with its four b-tag
   columns and 8 one-hot blocks of 32 (``bundled_data``: 1,000,000 x 284,
   stored as 34 columns, 8 EFB bundles of 65 bins and 2 packed b-tag
   pairs of 9 codes, B = 255), one per growth mode:
     4i ``exact``, with a 250,000-row validation set (seed 1),
     4j ``frontier``, 4k ``batched`` (K=16), 4l ``batched_part`` (K=16);
   before them phase 3 runs again on the stored matrix: the root pass
   (histogram.cu, K=3), both slot kernels at S = 16 with half the rows
   active and the partitioned-layout pass at S = 16 with every tile
   active (two feature tiles at C = 34), each held to its plain version
   computed in float64 (a cell at a bundle's bin 0 sums ~500,000 terms),
   timed against the f32 plain version, its bound and one index_add_;
   each bundled path prints C and B, its bundles and pairs, its kernels'
   plans (feature tiles, replicas), its launches and the splits of its 5
   trees on bundled and on packed features, and must reach the JAX
   package's train AUC within 2e-3, split at least once on a bundled and
   once on a packed feature, and (4i) keep valid scores within 1e-5 of
   ``predict(raw_score=True)``;
   then path 4q, a custom objective: exact growth on bench.py's workload
   with ``fobj`` returning the logistic gradients in numpy
   (``logistic_fobj``) and ``metric=auc``, held to the JAX package's AUC
   within 2e-3, with the event-timed ms an iteration of its round trip
   (the scores to the host, the fobj call, the two copies back);
   then the row-sampling paths on the same binned data (SAMPLING_PATHS),
   whose key stream is the JAX package's (a valid set puts it on the
   per-iteration stream, as DART and RF always are; without one
   ``lgb.train`` takes the fused blocks):
     4zb ``exact``, ``bagging_fraction=0.8``, ``bagging_freq=1``, with a
        250,000-row validation set (seed 1), ``metric=auc`` and early
        stopping, its valid AUC held at every iteration,
     4zc ``batched_part`` (K=16), ``bagging_fraction=0.5``,
        ``bagging_freq=2``, ``feature_fraction=0.8``,
     4zd ``frontier``, ``boosting=goss`` (``top_rate=0.2``,
        ``other_rate=0.1``, ``learning_rate=0.25``: 4 iterations of
        warm-up, then 4 sampled), 8 rounds, each sampled iteration's top
        rows (at least 200,000) and others (within 1.5% of their
        expectation) printed and held,
     4ze ``batched`` (K=16), ``boosting=dart`` (``drop_rate=0.5``,
        ``skip_drop=0``), 8 rounds, with the validation set, its drop sets
        held equal to the JAX package's and its model text reloaded,
     4zf ``exact``, ``boosting=rf`` (``bagging_fraction=0.632``,
        ``bagging_freq=1``, ``feature_fraction=0.8``), with the
        validation set and a model-text reload (``average_output``);
   each held to the JAX package's train AUC within 2e-3, every tree
   splitting, valid scores within 1e-5 of ``predict(raw_score=True)`` and
   reloaded texts within 1e-6, with its s/iter beside the dense binary
   path of its growth mode and the event-timed ms of a mask draw, of
   GOSS's selection and of DART's drop-and-normalize replay;
   then the categorical paths, binary with ``categorical_feature`` on
   ``categorical_data`` (1,000,000 x 32: bench.py's 28 features and four
   id columns of 3, 24, 1,000 and 20,000 ids, the last spread over ids up
   to 60,000), one per growth mode:
     4m ``exact``, with a 250,000-row validation set (seed 1),
     4n ``frontier``, 4o ``batched`` (K=16), 4p ``batched_part`` (K=16);
   before them phase 3's root pass runs again on its stored matrix
   (histogram.cu, K=3, held to float64); each categorical path must reach
   the JAX package's train AUC within 2e-3, split on a categorical
   feature at least once with at least one split sending more than one
   category left, and prints its categorical splits, its widest raw
   bitset and its largest category sent left (one path at least must send
   an id of 256 or more); 4m keeps valid scores within 1e-5 of
   ``predict(raw_score=True)`` and its model text, reloaded, predicts the
   1,000,000 rows within 1e-6;
   then the multiclass paths, ``num_class=5`` on ``multiclass_data``
   (500,000 x 28: bench.py's features, its target cut at its quintiles
   into 5 balanced classes; the shape at which the JAX package measured
   multiclass on its own chip), 5 trees an iteration, one a class:
     4r ``exact``, ``multiclass``, with a 125,000-row validation set
        (seed 1), early stopping after 5 rounds and a model-text reload,
     4s ``frontier``, ``multiclassova``, 4t ``batched`` (K=16) and 4u
        ``batched_part`` (K=16), ``multiclass``;
   each path's train ``multi_logloss`` (``multi_error`` printed beside
   it), and 4r's valid ``multi_logloss`` at every iteration, are held
   within 1e-3 relative of the JAX package's (4u to 4t's constant), every
   class tree must split, 4r's valid scores must be within 1e-5 of
   ``predict(raw_score=True)`` and its reloaded model text within 1e-6,
   and each path prints its seconds, launches and syncs an iteration
   beside the dense binary path of the same mode;
   then the ranking paths, ``lambdarank`` on ``ranking_data`` (500,000 x
   28 in 5,013 consecutive queries of 50-150 docs, relevance 0-4 cut at
   the global quantiles 0.5/0.8/0.95/0.99 of bench.py's target plus a
   per-query offset), metrics ndcg, map, topavg and topavgdiff at 1, 3
   and 5:
     4v ``exact``, with a 125,000-row validation set (seed 1) with its
        own groups, early stopping and a model-text reload,
     4w ``frontier``, 4x ``batched`` (K=16), 4y ``batched_part`` (K=16);
   each path also trains on the plain path with float64 histogram sums
   (deterministic), whose train ndcg@1/3/5 and map@5, and 4v's valid
   ndcg@5 at every iteration, are held within 1e-3 relative of the JAX
   package's (4y to 4x's constant; topavg and topavgdiff printed beside
   them); the kernel run is held to the same within 1e-3 where its trees
   are the plain run's (raw predictions within F64_RAW_TOL), and within
   RANK_PARTED_REL_TOL where, after tree 0, they part (the kernels'
   summation order moves leaf values by ~1e-6, which reorders a query's
   docs whose scores lie that close); 4v's valid scores must be within
   1e-5 of ``predict(raw_score=True)`` and its reloaded text within 1e-6;
   then 4zg, ``frontier`` lambdarank on the same data with
   ``bagging_fraction=0.8``, ``bagging_freq=1`` (one draw a query, the
   fused key stream, the plain run drawing the same masks), held as 4w
   (its JAX constant parts from the port's forests at a gain tie, found on
   the CPU by scripts/gain_tie_probe.py, so both runs are held as a parted
   one is) and with every query wholly in or out of each mask; then the
   cross-entropy paths on ``xentropy_data``
   (bench.py's 1,000,000 x 28 with labels sigmoid(t)): 4z ``frontier``
   ``xentropy`` (metrics xentropy and kldiv) and 4za ``batched`` (K=16)
   ``xentlambda`` with weights uniform in [0.5, 1.5], each train metric
   held within 1e-3 relative; each of 4v-4za must split in every tree
   and prints its seconds, launches and syncs an iteration beside the
   dense binary path of the same mode, its binning seconds and its
   gradient's device ms an iteration (CUDA events); then the lambdarank
   gradient at MSLR-WEB30K's shape (31,531 queries of 1-1,251 docs, ~120
   on average) on the card, timed, its peak memory read and held under
   its cap, and held to a float64 per-query version on a sample of
   queries with the longest one, within 1e-4 of each query's sum of |g|;
   then the constraint paths (CONSTRAINT_PATHS, Queue 1 #4/#6): 4zl
   ``exact`` with forced splits (FORCED_SPLITS, written to a temporary
   directory: four BFS steps) and 4zm ``exact`` with CEGB and bagging
   (CEGB_PARAMS) on bench.py's binary data right after 4zb-4zf, and
   4zh-4zk, ``objective=regression`` with MONOTONE_CONSTRAINTS (+1 on
   feature 0, -1 on feature 1) under exact, frontier, batched (K=16) and
   batched_part (K=16) on the regression data right after 4e-4h; each
   monotone path held within 1e-3 relative of the JAX package's train l2
   and monotone on a grid (MONO_GRID values along each constrained
   feature at MONO_GRID_ROWS rows, within MONO_GRID_TOL), with its splits
   on features 0 and 1 printed; 4zl within 2e-3 of the JAX package's
   train AUC, nodes 0-3 of every tree the forced (split leaf, feature,
   threshold bin), the hist_for_leaf route launched and counted; 4zm
   within 2e-3 of its AUC, on the JAX package's features and with its
   final ``feature_used``, the lazy state a [28, 1,000,000] uint8 table on
   the card; each prints its seconds, launches and syncs an iteration
   beside the dense binary path of its growth mode;
   then the float64 paths (F64_PATHS, Queue 1 #3), exact growth with
   float64 histograms through histogram.cu's f64 variant on data phase 4
   already binned: 4zn ``gpu_use_dp=true`` binary on bench.py's data (after
   4zl-4zm), 4zo ``tpu_hist_dtype=float64`` on the categorical data (after
   4m-4p) and 4zp ``gpu_use_dp=true`` lambdarank on the ranking data
   (after 4zg); each launches the f64 kernel once per histogram pass and
   no other kernel, holds the JAX package's f64 constant (AUC within 1e-5
   absolute, ndcg@1/3/5 within 1e-5 relative) and prints its s/iter,
   launches and syncs beside 4a, 4m and 4v;
   then the input formats and prediction extras (Queue 1 #16, #8), after
   4zn:
     4zq exact growth from a scipy CSR of 1,000,000 x 1,000
        (``sparse_data``: eight one-hot blocks of 100 columns, one stored
        1.0 a row a block, and 200 lognormal columns at 1%), binned
        without densifying it, every one-hot column in an EFB bundle; its
        train AUC within 2e-3 of the JAX package's, predict on the CSR
        (its first SPARSE_PREDICT_ROWS rows) equal to predict on the rows
        densified block by block; binning seconds, s/iter, launches and
        the port's kernels' device ms an iteration beside 4a's;
     4zr the first 250,000 rows of bench.py's data as a CSV file with a
        header and 100,000 rows of 4zq's CSR as a libsvm file, each binned
        byte for byte as the same rows in memory, and the binary cache of
        4a's whole Dataset, loaded byte for byte, from which 2 rounds
        under ``gpu_use_dp`` grow 4a's Dataset's trees node for node;
     4zs the prediction extras on trained models: pred_leaf of 4a's 1M
        rows on the card, equal to the training replay's leaves
        (``replay_leaves_binned``) and summing to the raw scores;
        pred_early_stop on 4a and 4r at margin 1e30 equal to predict, and
        at margin 10 (freq 5) and the first iteration's median margin
        (freq 1) equal to a host emulation of the rule on 10,000 rows;
        pred_contrib on the card on 10,000 rows of 4a, 4m, 4r and 4zq,
        each class summing to its raw score within 1e-6 x max(1, |raw|)
        and on 50 rows (10 of 4zq's) within 1e-9 of a row's sum of
        |contrib| of the plain recursion (``predict_contrib_plain``);
   then the Python surface (Queue 1 #17) and resetting the training data
   (#20) on bench.py's data and 4zr's CSV, each path with the launch
   counts set to 0 just before and read just after, each launching
   histogram.cu:
     4zt ``LGBMClassifier(num_leaves=255, max_bin=255, n_estimators=5)``
        on 4a's 1M rows with the labels as "neg"/"pos", a validation set
        of 250,000 rows (seed 1), ``eval_metric="auc"`` and early stopping
        after 5 rounds: its train AUC (``predict_proba`` at 5 iterations)
        within 2e-3 of 4a's JAX constant, ``predict`` giving the string
        labels, 5 valid AUCs and a best iteration; on its booster
        ``dump_model``'s leaf values equal to the trees', ``get_leaf_output``
        on sampled leaves and ``get_split_value_histogram`` counting every
        split on each feature; the estimator pickled and unpickled
        predicting 10,000 rows exactly as before; and ``LGBMRegressor``
        with 4e's parameters, 5 estimators, 4e's validation set and a
        callable l2 metric: train l2 within 1e-3 relative of 4e's JAX
        constant, the callable's valid values within 1e-3 of 4e's;
     4zu ``lgb.cv`` on 4a's 1M rows (a Dataset with the default
        ``free_raw_data=True``), binary with ``metric=auc``, 5 stratified
        shuffled folds (seed 0), 3 rounds: the folds partition the rows,
        each test fold's positive share within one row of the whole's,
        each round's ``valid auc-mean`` and ``-stdv`` within 2e-3 of the
        JAX package's f64 constants, and 5 fold boosters on CUDA;
     4zv the command line in the process on 4zr's CSV: ``task=train``
        (4a's parameters, 5 trees), ``task=predict`` on the first 50,000
        rows (a CSV of their own), equal to ``Booster.predict`` to
        ``%.12g``, and ``task=convert_model``, whose C++ compiled with
        ``g++ -O2 -shared -fPIC`` scores 1,000 rows within 1e-6 relative;
        ``python -m lightgbm_tpu_torch task=predict`` as a subprocess on
        the CUDA default writing the same file; and 2 rounds under
        ``gpu_use_dp=true`` through the CLI and through
        ``lgb.train(Dataset("dense.csv"))``, the two models' trees
        identical in their text;
     4zw 3 rounds on rows 0-500,000 of 4a's data with 4zt's validation
        set, ``reset_training_data`` to rows 500,000-1,000,000 binned with
        the first half's mappers: the valid AUC unchanged within 1e-7, the
        new training scores within 1e-5 of ``predict(raw_score=True)`` on
        the new rows; 2 more rounds, the valid AUC within 2e-3 of the JAX
        package's f64 constant; and under ``gpu_use_dp`` (whose kernel
        runs repeat) the same reset through ``reset_training_data`` and
        through ``update(train_set=...)``, one round after it, the two
        ways' trees identical and their scores within 1e-5;
   then the serving path (Queue 1 #10), after 4r-4u in the workloads part:
     4zx a binary model of SERVE_ROUNDS iterations grown under
        ``frontier`` on 4a's data (its launches counted), 4m's and 4r's
        boosters and 4m's model text reloaded through
        ``ModelRegistry.load_file``, served on the card by a
        ``ServingEngine`` warmed over every bucket (one CUDA graph an
        entry): requests of SERVE_SIZES rows (10,000 split across
        buckets) through ``ServingEngine.predict``, a ``MicroBatchQueue``
        from SERVE_THREADS threads, ``serve_stdin`` and ``make_server`` on
        127.0.0.1 (``urllib``), every response ``Booster.predict``'s on
        the same rows bit for bit, raw and transformed, and no graph
        captured and no cache miss after warmup; the replay backend equal
        to the traversal; the cascade at margin inf the full model, at 0
        the first iterations, at 10 and at the median stage-1 margin a
        host emulation of the rule; int16 leaves within SERVE_QUANT_REL of
        the full scores (relative to the largest); a hot roll to a staged
        50-iteration model capturing before the swap and serving it from
        the next request on; each bucket's p50/p99 latency through the
        engine and through HTTP, rows a second at bucket 4,096, the
        captures of warmup and bucket 4,096's graph replay against the
        same entry op by op, printed beside the card's name and power
        limit;
   then out-of-core streaming (Queue 1 #11) and packed bin words (#9), in
   the compare part:
     4zy 4b's data and parameters streamed from a .npy memory map in
        chunks of STREAM_CHUNK_ROWS rows (8 chunks; round 1's sample the
        whole data), streamed ``auto`` packing them into int32 words: the
        mappers and the trees those of an in-memory frontier run with the
        same sample (every row; 4b's loader samples 200,000 rows at
        random, the stream a reservoir), the trees under phase 5's
        frontier tie rule (WAVE_PARTING; its AUC where they part), the
        train AUC within
        2e-3 of the JAX package's 4b constant, ``predict`` the training
        scores within 1e-5, and the word variants of both kernels
        launched (and no uint8 one); its s/iter beside 4b's, the
        pipeline's overlap_efficiency and ingest rows a second, and one
        more iteration's launches and syncs;
     4zz frontier in memory with ``tpu_bin_packing=byte`` on 4b's data
        (4b's trees under the same rule), and ``none`` against
        ``nibble`` on ``small_bin_data`` (1,000,000 x NIBBLE_FEATURES of
        2-16 levels): nibble's stored columns at most half the features
        and fewer than none's, its trees none's under the same rule, its
        AUC within 2e-3 of none's; both packed runs on the word variants
        only;
   then checkpoints, resume and resilience (Queue 1 #12, #18), 4zza,
   4zzc and 4zzd in this process after 4zv, 4zzb in the compare part
   after 4zz, each run's launches counted and summed into its row:
     4zza exact growth with ``gpu_use_dp=true`` (CKPT_PARAMS) on 4a's
        data for CKPT_ROUNDS iterations in this process, uninterrupted and
        without checkpoints (its first 5 iterations' AUC the JAX
        package's 4zn constant within 1e-5), then two child processes of
        this script (``--ckpt-child``) on 4a's Dataset from its binary
        cache, with a checkpoint a round: the victim, killed by
        ``fault_inject=kill@iter:CKPT_KILL_AT`` (SIGKILL, return code -9)
        after its snapshots, and the resumer of its directory, whose model
        text must be the uninterrupted run's byte for byte; each
        snapshot's capture ms (the state's copy to the host) and write ms
        (npz, sha256, fsync, renames, the manifest), and the s/iter with a
        checkpoint a round (the children's) and without (this run's);
     4zzc the same parameters with ``supervise=true`` and
        ``fault_inject=crash@iter:CKPT_CRASH_AT`` in this process: one
        restart from the snapshot of that iteration, the trees of 4zza's
        uninterrupted text byte for byte (the parameters the text echoes
        are this run's); its snapshots and s/iter timed as 4zza's, in this
        process beside 4zza's uninterrupted run;
     4zzd a ``ServingEngine`` watching 4zza's directory rolls its newest
        snapshot in (the guarded roll, its CUDA graphs captured on the
        poll) and answers CKPT_SERVE_ROWS rows as that snapshot's booster
        predicts them, bit for bit; then one more iteration of the
        uninterrupted run saved there under ``ckpt_torn``: the watcher
        keeps its generation and its answers, and ``load_latest`` falls
        back to the snapshot before;
     4zze (the fleet, #15 slice a) 4zza's booster refitted
        (``fleet.Refitter``) at REFIT_DECAY on 1,000,000 rows of bench.py's
        data of seed 1 with features 0-3 moved by REFIT_SHIFT, its AUC
        there held to the JAX package's (JAX_REFIT_AUC) within
        REFIT_AUC_TOL, against the host loop (``refit_device=false``)
        within 1e-5 relative and 1e-6, ``decay_rate=1.0`` and the trees'
        structure byte for byte, a held Refitter's later cycle equal to a
        one-shot refit; the card's seconds against the host loop's, the
        routing's ms against the loop's; the same for 4r's 5-class booster
        on MULTICLASS_ROWS rows, in the workloads part after 4zx;
     4zzf (workloads, after 4zx) 4m's and 4r's boosters as models a and b
        of one app built from the config (``serve_qos_weights``,
        ``serve_qos_quota_rows``, a cascade, ``serve_latency_budget_ms``):
        QOS_FLOOD_THREADS threads flood a past its quota while b's
        threads stay within theirs; only a's requests shed, the rows
        served converge to the weights within QOS_RATIO_TOL; then the
        autotuner, its budget below the measured p99, walks the margin
        down a rung a step; every answer the cascade's host emulation at
        its margin, no capture or cache miss after warmup;
     4zzg the fleet loop: two replica processes of this script
        (``--fleet-replica``, ``build_app`` with ``fleet_kv_dir`` and a
        copy of 4zza's directory taken before 4zzd) under drifted HTTP
        traffic reach ``drift: warn``; here a refit worker refits the
        served booster on a window of that traffic and publishes it with
        the window's profile (``save_refit``); the replicas roll it one at
        a time (each answer the old or the refitted booster's ``predict``
        bit for bit, no error, shed or capture after warmup, drift back
        to ok, ``/stats/cluster`` converged), pass over a torn snapshot
        and refuse, in the first replica's canary, one with NaN leaves,
        which the second skips; each replica's roll seconds and the p99
        during the roll;
     4zzb frontier growth on CKPT_STREAM_ROWS rows of 4b's data streamed
        in 4 chunks of packed words with a checkpoint a round:
        uninterrupted, then a victim sent SIGTERM by
        ``kill@iter:CKPT_STREAM_KILL_AT:term`` (the callback latches it
        and writes that iteration's snapshot; the signal then reaches a
        handler that raises, so the victim runs in this process), then
        its directory resumed: the scores, bag mask and model text at the
        resumed run's first iteration the snapshot's bit for bit, the
        resumed trees the uninterrupted run's under phase 5's frontier
        rule (the card's f32 sums do not repeat) and its AUC within
        CKPT_STREAM_AUC_TOL, the word variants launched;
     4zzh training observability (compare, after 4zw, on 4b's data):
        exact f64 at ``observability=full`` with an event file, the stats
        port, model statistics, the flight recorder, a 2-iteration
        Perfetto window and a throughput SLO, while a thread scrapes
        ``/metrics``: its trees the ``none`` run's byte for byte, the
        iteration counter rising in the scrapes, ``/roofline``'s shares
        at most 1, the Chrome trace naming histogram.cu's kernels, one
        ``iteration`` record an iteration, ``ModelStats.importance`` equal
        to ``feature_importance``; then frontier f32 OBS_ROUNDS rounds at
        none, basic and full in turns (twice each): the launches the
        trees' waves need at every level (none's where the trees are
        none's), the trees none's under the frontier rule as none's own
        second run is (from a tree that parts on, the AUC), s/iter,
        launches and syncs an iteration; then NaN gradients at iteration
        OBS_NAN_AT: ``raise`` under full at that iteration, under basic
        after the block's one fetch, ``warn`` not aborted, a flight dump
        naming each raise;
     4zzi serving observability (workloads, after 4zx): 4zx's model
        served with ``obs_trace`` at sample 1.0 and both SLOs beside the
        same app without them, OBS_SERVE_REQUESTS HTTP requests each with
        a trace header: every answer ``predict``'s bit for bit, every
        trace a full span tree under its inbound ID, no capture after
        warmup, ``/slo`` answering; p50/p99 with and without tracing;
     4zzj distributed learners (#13 slice a, #14; main, last): two rank
        processes of this script (``--dist-rank``), each loading the
        whole of 4a's data and keeping its block of rows, join a
        ``torch.distributed`` group over gloo (two ranks on one card take
        gloo by the group's rule, CUDA tensors crossing through pinned
        host memory) and train NUM_ITERS
        rounds of 4a's parameters under DIST_RUNS: (a) exact float64
        data-parallel, node for node with 4zza's trees (a located tie the
        one exception), AUC within F64_AUC_TOL of the 4zn constant; (b)
        frontier with the reduce-scatter learner, with the all-reduce one
        and voting at ``top_k`` = the feature count, each held to 4b's
        trees under phase 5's frontier rule and AUC; (c) voting at
        ``top_k=3``, its train logloss non-increasing within 1e-6 and
        ending within 10% of 4b's drop; (d) feature-parallel exact f32
        and (e) data-parallel batched_part, held to 4a's and 4d's trees
        under the same rule and AUC; both ranks' model digests equal,
        each run's kernels launched on both ranks; s/iter at 2 ranks
        against 1, all-reduce ms a split, payload a wave (by the JAX
        package's rule and as received) and the transport;
   every path of 4a-4d, 4m-4za, 4zb-4zp, 4zq and 4zy also trains one more
   iteration under torch.profiler and prints its CUDA kernel launches,
   synchronisations and the port's kernels' device time;
5. the kernel path against the plain path on the card (200,000 rows, 2
   iterations) for exact, frontier, batched, batched with
   ``tpu_batched_pack=true`` (which launches the slot kernel on its
   batched branch) and batched_part, the plain path's histograms summed
   in float64 and in blocked f32 sums (``GrowParams.plain_sums``
   ``"blocked"``: each cell's rows in runs of 16,384 rows landing in that
   cell, the runs' sums added in order; a single running f32 sum a cell,
   as ``index_add_`` keeps, drifts on bins of many rows as far as a small
   fault moves a histogram): trees
   identical up to f32 gain ties (tests/test_parity.py's rule), and raw
   predictions within 1e-5 when the trees are identical; on bench.py's
   data, on the bundled data, on the categorical data, and batched
   multiclass (4t's call) on the multiclass data; and, on bench.py's data,
   every grower again on bagged rows (``bagging_fraction=0.5``: zeros in
   the count channel) and on GOSS's rows (``learning_rate=1.0``: the
   second iteration samples, its gradients amplified) against the float64
   plain path; the frontier row again with the data streamed
   (STREAM_COMPARE_CHUNK_ROWS rows a chunk, 4 chunks, packed words: the
   word variants) against both plain paths; every frontier row may part
   at a tie located by the rows split (WAVE_PARTING: a tie of one leaf's
   candidates or a null split, and every split before it within 3e-5 of
   the root's gain), from where it is held to its AUC; and every grower
   but batched_pack under
   MONOTONE_CONSTRAINTS against the float64 plain path, where trees may
   part at a tie of one leaf's clamped candidates or at a null split
   (``parting_tie``, gains within CLAMP_PARTING of the root's, and those of
   the splits both made before it too), and the trees after a tree that
   differs regrow (SAMPLED_TIE_GAIN_REL); from there they are held to
   their AUC; and exact with forced splits and CEGB, held to the tie rule
   and F64_RAW_TOL; and on the dense and the bundled data, exact growth
   with ``gpu_use_dp=true``, and on the dense data with forced splits and
   CEGB too (the f64 ``hist_for_leaf`` route): the f64 kernel path, the
   f64 kernel path again and the f64 plain path, every pair's trees
   identical node for node with no tie rule and raw predictions within
   1e-6;
6. a ``kernels`` JSON line (each kernel's launches summed over every
   path of phase 4; histogram.cu's launches through ``hist_for_leaf`` as
   the entry ``histogram_leaf``, its float64 variant's as
   ``histogram_f64``, with the f64 ``hist_for_leaf`` route's launches of
   phase 5's forced row, its word variants' as ``histogram_words`` and
   ``hist_slots_words``, with phase 5's streamed row's), the card line,
   and the result line
   ``{"ok": true, "device": {...}}``. No grower calls the in-tile
   partition (nor does the JAX package's), so its entry's path launches
   are 0 and its phase-3 calls are its only launches.

Phases 1-3 and 4a-4d run in this process alone. Then two more processes
of this script (``--part workloads`` and ``--part compare``, given the
dense paths 4a-4d for their ratios) share the card with it, so that the
host-bound paths overlap: this process runs 4q, 4zb-4zf, 4zl-4zn,
4zq-4zv, 4zza, 4zzc, 4zzd, 4zze, 4zzg and 4zzj (4zza's two child
processes, 4zzg's two replicas and 4zzj's two ranks too); ``workloads`` 4e-4h, 4zh-4zk, 4i-4p, 4zo,
4r-4u, their prediction extras, 4zx, 4zzi, 4r's refit and 4zzf;
``compare`` 4v-4za, 4zg, 4zp, 4zy, 4zz, 4zzb, 4zw, 4zzh and phase 5 (4b's trees reach it in a file, FRONTIER_REF, for 4zz). Each
process sets its own launch counts to 0 just before each path and reads
them just after; phase 6 sums them. The seconds of the paths from 4q on,
and the bundled and categorical kernel rows, are taken while the three
processes share the card and the host's cores.

Exits non-zero without a result when no CUDA device is available.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import json
import os
import pickle
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch import cli as port_cli
from lightgbm_tpu_torch import device as port_device
from lightgbm_tpu_torch import engine as port_engine
from lightgbm_tpu_torch import objectives as port_objectives
from lightgbm_tpu_torch import random as port_random
from lightgbm_tpu_torch.boosting import dart as port_dart
from lightgbm_tpu_torch.boosting import gbdt as port_gbdt
from lightgbm_tpu_torch.boosting import goss as port_goss
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.core import binpack
from lightgbm_tpu_torch.core import grow_batched_part
from lightgbm_tpu_torch.core import histogram as hist
from lightgbm_tpu_torch.core import kernels
from lightgbm_tpu_torch.core import partition
from lightgbm_tpu_torch.core import renew
from lightgbm_tpu_torch.core import repack
from lightgbm_tpu_torch.core import shap
from lightgbm_tpu_torch.core import tree as tree_mod
from lightgbm_tpu_torch.io.binning import BinType
from lightgbm_tpu_torch.io import parser as port_parser
from lightgbm_tpu_torch.io.dataset import Metadata
from lightgbm_tpu_torch.metrics import auc

# Train AUC of the JAX package (lightgbm_tpu) on phase 4's data and
# parameters for each growth mode, taken on the CPU backend with chunked
# histogram sums (``matmul``: the default ``scatter`` keeps one running f32
# sum a cell, which drifts on bins of many rows; the kernels sum in blocks)
# by
#   JAX_PLATFORMS=cpu python scripts/jax_reference_auc.py --growth MODE \
#       --hist-impl matmul
# batched_part holds to batched's constant, as before
JAX_REFERENCE_AUC = {"exact": 0.9623968698328734,
                     "frontier": 0.9551473493737143,
                     "batched": 0.9622066718465125,
                     "batched_part": 0.9622066718465125}
AUC_TOLERANCE = 2e-3

MAIN_ROWS, NUM_FEATURES, NUM_ITERS = 1_000_000, 28, 5
PARAMS = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
          "verbosity": -1}
# the growth modes the port covers, each a path of its own
GROWTH_PARAMS = {"exact": {"tree_growth": "exact"},
                 "frontier": {"tree_growth": "frontier"},
                 "batched": {"tree_growth": "batched",
                             "tree_batch_splits": 16},
                 "batched_part": {"tree_growth": "batched",
                                  "tree_batch_splits": 16,
                                  "tpu_batched_part": "true"}}
COMPARE_ROWS, COMPARE_ITERS = 200_000, 2

# the bundled paths of phase 4 (binary, default enable_bundle and
# enable_nbit_packing, on ``bundled_data``): a growth mode each; 4i also
# keeps a validation set of VALID_ROWS rows (seed 1)
BUNDLED_PATHS = {"4i": "exact", "4j": "frontier", "4k": "batched",
                 "4l": "batched_part"}
# Train AUC of the JAX package on the bundled paths' data and parameters,
# taken on the CPU backend with chunked histogram sums by
#   JAX_PLATFORMS=cpu python scripts/jax_reference_auc.py --data bundled \
#       --growth MODE --hist-impl matmul
JAX_BUNDLED_AUC = {"exact": 0.8854787837277004,
                   "frontier": 0.8201513043682455,
                   "batched": 0.8571510037666036,
                   "batched_part": 0.8571510037666036}
# slots of the bundled shapes of the slot and part kernels (phase 3)
BUNDLED_SLOTS = 16
# phase 5 on the bundled data: raw predictions of identical trees within
# this, against the f32 plain path. A bundled feature's default bin is
# rebuilt as the leaf's total minus its other bins, so a split there
# carries the f32 rounding of the leaf totals down to the leaves under it:
# one ulp of a 200,000-row root's sum of |g| (ulp(1e5) = 7.8e-3 in a
# gradient sum) over a 20-row leaf's hessian (>= 4.8 in the second tree) is
# 1.6e-3 of its value, 1.6e-4 after shrinkage; a bin-0 cell of a bundle
# holds ~100,000 rows, where the f32 plain path's single running sum
# drifts too (measured on an H100: 2.8e-4 to 4.0e-4 in PR 9, 2.7e-4 to
# 3.0e-4 in PR 11; against the float64 path 1.7e-5 to 4.2e-5)
BUNDLED_RAW_TOL = 6e-4
# phase 5 against the plain path with float64 histogram sums, every data
# set: raw predictions of identical trees within this. The split search
# takes a right child's sums as its leaf's total minus a float32 prefix
# sum of its bins, so two summation orders of the same cells (the kernels'
# blocks, the float64 sums rounded once) move a small leaf's gradient sum
# by an ulp of its ancestors' (ulp(5e4) = 3.9e-3), and a 20-row leaf of
# the second tree, whose hessian can be below 1, carries that into its
# value (measured on an H100: 1.1e-4 to 1.4e-4 on bench.py's data, 1.7e-5
# to 4.2e-5 on the bundled data, 2.7e-4 on the multiclass data; the f32
# plain path's trees part at a tie on bench.py's data, so there its 1e-5
# is never reached). That error is a leaf value's, so it scales with the
# shrinkage: the measurements are at the default learning rate,
# F64_RAW_TOL_LR, and a run at another rate is held to F64_RAW_TOL times
# its rate over that (phase 5's GOSS rows, at learning_rate 1.0 so that
# the second iteration samples, measured 1.21e-3 with identical trees on an
# H100, 1.2e-4 scaled back)
F64_RAW_TOL = 5e-4
F64_RAW_TOL_LR = 0.1
# phase 5 on sampled rows (SAMPLED_COMPARE): a tree may break the tie
# rule's count of substituted splits where its gain sum is within this of
# the other's. With fewer rows in a leaf, near-tied gains decide more of
# frontier's last wave: float32 against float64 sums on the CPU part
# bagged tree 0 with 5 positional mismatches and 6 substituted splits,
# gain sums 2.1e-6 apart (scripts/summation_order_probe.py --data dense
# --growth frontier --sampled bagged); an H100 run 3 and 6, 6e-8 apart.
# The monotone rows use it too (``tie_limits``)
SAMPLED_TIE_GAIN_REL = 1e-5


class PartingLimits(NamedTuple):
    """How far apart two runs' gains may be where their trees part at a tie
    (``parting_tie``): relative to the gain of the other run's split of
    the same rows (``gain_rel``), and relative to the tree's root gain
    (``root_rel``), which also bounds the gains of the splits both trees
    made before it and of a null split (a split of one tree's that the
    other leaves whole: a float32 sum cannot tell it from no split); None
    sets no limit of that kind, and without ``root_rel`` no split is
    null. ``null_rel``, where given, bounds a null split's gain instead of
    ``root_rel``."""
    gain_rel: Optional[float] = None
    root_rel: Optional[float] = None
    null_rel: Optional[float] = None


# phase 5 on data with categorical features: the most two runs' gains may
# differ at the node where their trees part on one leaf (``parting_tie``).
# The summation order alone moves the gains of splits both runs share by up
# to 6.7e-2 on the categorical data at COMPARE_ROWS, and the parting nodes'
# by 3e-5 to 8.6e-3 (scripts/summation_order_probe.py, f32 against float64
# histogram sums, exact, frontier and batched); a kernel that sums wrong
# moves them by far more. Against the float64 plain path too, exact and
# frontier part at such a tie (a one-vs-rest split and its mirror: the
# same rows, gains 1.5e-6 and 2.7e-6 apart on an H100), so the positional
# rule alone does not hold there
CAT_PARTING = PartingLimits(gain_rel=0.1)
# phase 5 under monotone constraints: how far apart, relative to the
# tree's root gain, two runs' gains may be where their trees part at one
# leaf, and on every split both made before it (``parting_tie``). A bound
# that binds clamps a leaf's candidates to the same outputs, so their gains
# tie up to float32 rounding, or exactly, and the summation order picks
# one. A clamped gain is a small difference of large terms, so its
# rounding is of the terms' size, not the gain's: float32 against float64
# sums on the CPU move the gains of tree 0's splits that both make by up
# to 2.6e-3 of their own but 4.1e-6 of the root's, under every grower
# (scripts/summation_order_probe.py --data dense --constraint monotone;
# the card's kernels against float64 sums in PERF.md, from
# scripts/constraint_tie_repeats.py). Faults planted there that zero every
# 65,536th or 4,096th row of the float32 sums (the probe's --plant-fault)
# move them by 1.1e-4 and 6.2e-4 of the root's, and fail the rule under
# every grower
CLAMP_PARTING = PartingLimits(root_rel=1e-5)
# phase 5's frontier rows without categorical features or constraints: a
# wave splits every leaf of positive gain, so one tie (near-tied
# candidates of one leaf, or a null split: a zero gain rounded up in one
# run, which takes one of the last wave's leaf-capped slots) substitutes
# several splits in that wave and the waves after it, below the parted
# leaf and at the leaf cap. Such a tree may part at a tie located by the
# rows split (``parting_tie``): that tie and every split both trees made
# before it within ``root_rel`` of the root's gain, a null split's gain
# within ``null_rel`` of it. Float32 against float64 sums on the CPU
# (scripts/summation_order_probe.py --data bundled --growth frontier, 200k
# rows, seeds 0-4 with running f32 sums and 0-1 with blocked ones) part
# both trees of every run at such a tie, the tie up to 4.3e-6 and the
# splits before it up to 1.55e-5 of the root's gain apart (null splits
# 1.6e-10 of it); seed 3 parts as an H100 did once (PR 18: 3 positional
# mismatches, 6 substituted splits, gain sums 5.6e-7 apart). The faults
# the probe plants (--plant-fault 65536 at seeds 0-2, 4096 at seed 0:
# every 65,536th or 4,096th row dropped from the f32 sums) fail the rule,
# the seed-0 ones with the splits before their parting 5.5e-5 and 6.0e-4
# of the root's gain apart
WAVE_PARTING = PartingLimits(root_rel=3e-5, null_rel=1e-8)

# the categorical paths of phase 4 (binary on ``categorical_data``, its id
# columns passed as categorical_feature): a growth mode each; 4m also keeps
# a validation set of VALID_ROWS rows (seed 1) and round-trips its model
# text
CATEGORICAL_PATHS = {"4m": "exact", "4n": "frontier", "4o": "batched",
                     "4p": "batched_part"}
# Train AUC of the JAX package on the categorical paths' data and
# parameters, taken on the CPU backend with chunked histogram sums (no f32
# drift; the default scatter path's single running sums gave frontier
# 0.9041706457162489) by
#   JAX_PLATFORMS=cpu python scripts/jax_reference_auc.py \
#       --data categorical --growth MODE --hist-impl matmul
JAX_CATEGORICAL_AUC = {"exact": 0.920127942240841,
                       "frontier": 0.9026731717792262,
                       "batched": 0.9189803266249152,
                       "batched_part": 0.9189803266249152}
# Train AUC of the JAX package on path 4q's call (exact growth on bench.py's
# data, ``fobj=logistic_fobj``, FOBJ_PARAMS), taken on the CPU backend with
#   JAX_PLATFORMS=cpu python scripts/jax_reference_auc.py --fobj logistic \
#       --hist-impl matmul
JAX_FOBJ_AUC = 0.9624021520089908
MODEL_TEXT_TOL = 1e-6

# the regression paths of phase 4: a growth mode and an objective each; 4e
# also trains with a validation set of VALID_ROWS rows (seed 1)
REGRESSION_PATHS = {
    "4e": ("exact", {"objective": "regression"}),
    "4f": ("frontier", {"objective": "huber"}),
    "4g": ("batched", {"objective": "quantile", "alpha": 0.9}),
    "4h": ("batched_part", {"objective": "regression_l1"}),
}
VALID_ROWS, EARLY_STOPPING_ROUNDS = 250_000, 5
# The JAX package's train metric on each regression path, and on 4e its
# valid l2 after each iteration, taken on the CPU backend with
#   JAX_PLATFORMS=cpu python scripts/jax_reference_auc.py --growth MODE \
#       --objective OBJECTIVE [--valid] --hist-impl matmul
JAX_REFERENCE_METRIC = {
    "4e": {"train": 1.4741587178358107,
           "valid": [2.0017803309553637, 1.8299560803091888,
                     1.6875908146658127, 1.572029931702,
                     1.4791569630139199]},
    "4f": {"train": 0.5470970065769092},
    "4g": {"train": 0.18716961910357854},
    "4h": {"train": 0.8175396265150078},
}
METRIC_REL_TOL = 1e-3
VALID_SCORE_TOL = 1e-5

# the multiclass paths of phase 4 (``multiclass_data``: MULTICLASS_ROWS x 28
# in NUM_CLASS classes, the shape at which the JAX package measured
# multiclass on its own chip): a growth mode and an objective each; 4r also
# trains with a validation set of MULTICLASS_VALID_ROWS rows (seed 1), early
# stopping and a model-text reload
MULTICLASS_PATHS = {"4r": ("exact", "multiclass"),
                    "4s": ("frontier", "multiclassova"),
                    "4t": ("batched", "multiclass"),
                    "4u": ("batched_part", "multiclass")}
MULTICLASS_OBJECTIVES = ("multiclass", "multiclassova")
NUM_CLASS, MULTICLASS_ROWS, MULTICLASS_VALID_ROWS = 5, 500_000, 125_000
# The JAX package's train multi_logloss on each multiclass path, and on 4r
# its valid multi_logloss after each iteration, taken on the CPU backend
# with chunked histogram sums (``matmul``, no f32 drift) by
#   JAX_PLATFORMS=cpu python scripts/jax_reference_auc.py --growth MODE \
#       --objective OBJECTIVE --num-class 5 --hist-impl matmul [--valid]
# 4u holds batched_part to 4t's constant: batched_part grows batched's
# trees, and the JAX package on the CPU vmaps the classes and there runs
# its unpartitioned batched step
JAX_MULTICLASS_METRIC = {
    "4r": {"train": 1.228678822517395,
           "valid": [1.5083937644958496, 1.4234932661056519,
                     1.351672887802124, 1.2891716957092285,
                     1.2346508502960205]},
    "4s": {"train": 1.1551284790039062},
    "4t": {"train": 1.2298247814178467},
}
JAX_MULTICLASS_METRIC["4u"] = JAX_MULTICLASS_METRIC["4t"]

# the ranking paths of phase 4 (lambdarank on ``ranking_data``: RANKING_ROWS
# x 28 in ~5,000 queries): a growth mode each; 4v also trains with a
# validation set of RANKING_VALID_ROWS rows (seed 1) with its own groups,
# early stopping and a model-text reload
RANKING_PATHS = {"4v": "exact", "4w": "frontier", "4x": "batched",
                 "4y": "batched_part"}
RANKING_ROWS, RANKING_VALID_ROWS = 500_000, 125_000
RANKING_PARAMS = {"objective": "lambdarank",
                  "metric": "ndcg,map,topavg,topavgdiff",
                  "eval_at": [1, 3, 5]}
# the metrics a ranking path is held to (the fork's topavg and topavgdiff
# are printed beside the JAX package's)
RANKING_HELD = ("ndcg@1", "ndcg@3", "ndcg@5", "map@5")
# A ranking path's kernel run beside the same path's plain run with float64
# histogram sums, which is deterministic. The kernels' f32 atomics add in
# another order each run, which moves leaf values by ~1e-6 (tree 0 of 4x
# on an H100); where two leaves' values lie that close, a query's docs in
# them swap ranks, every pair of theirs gets another lambda, and the next
# trees part from the plain run's. Six kernel runs of 4x on one card gave
# the JAX package's metrics three times and, after such a parting, ndcg@1
# 7.95e-3 from them the other three (ndcg@3 2.9e-3, ndcg@5 1.8e-3); the
# plain run gave the JAX package's every time. So the plain run is held to
# the JAX constants within METRIC_REL_TOL; the kernel run is too where its
# trees are the plain run's, and where they part (never at tree 0, whose
# gradients are the same), within RANK_PARTED_REL_TOL
RANK_PARTED_REL_TOL = 2e-2
# the cross-entropy paths of phase 4 (``xentropy_data``: bench.py's
# MAIN_ROWS x 28 with labels sigmoid(t)): a growth mode, the parameters
# over PARAMS and whether the rows are weighted
XENTROPY_PATHS = {
    "4z": ("frontier", {"objective": "xentropy",
                        "metric": "xentropy,kldiv"}, False),
    "4za": ("batched", {"objective": "xentlambda"}, True),
}
# The JAX package's train metrics on each ranking path, and on 4v its valid
# ndcg@5 after each iteration and its best iteration, taken on the CPU
# backend with chunked histogram sums by
#   JAX_PLATFORMS=cpu python scripts/jax_reference_auc.py --data ranking \
#       --growth MODE --hist-impl matmul [--valid]
# 4y holds batched_part to 4x's constant: batched_part grows batched's trees
JAX_RANKING_METRIC = {
    "4v": {"train": {"ndcg@1": 0.8865863041805594,
                     "ndcg@3": 0.9125385135134905,
                     "ndcg@5": 0.9253591660621158,
                     "map@1": 0.9998005186515061,
                     "map@3": 0.9996841545315511,
                     "map@5": 0.9992486202540057,
                     "topavg@1": 0.035108717334929186,
                     "topavg@3": 0.03637209920872412,
                     "topavg@5": 0.03622581288649489,
                     "topavgdiff@1": 1.6316576900059845,
                     "topavgdiff@3": 1.4739011902387134,
                     "topavgdiff@5": 1.3635946538998562},
           "valid": [0.6910600018491493, 0.8395208053668606,
                     0.8868578742361473, 0.9074228059092496,
                     0.9186984365477405],
           "best_iteration": 5},
    "4w": {"train": {"ndcg@1": 0.8784645635633079,
                     "ndcg@3": 0.8963312922723665,
                     "ndcg@5": 0.9090194255316288,
                     "map@1": 0.9996010373030122,
                     "map@3": 0.9994680497373495,
                     "map@5": 0.9987565662610538,
                     "topavg@1": 0.005784959106323559,
                     "topavg@3": 0.011702905778309753,
                     "topavg@5": 0.017115499700778077,
                     "topavgdiff@1": 1.637642130460802,
                     "topavgdiff@3": 1.4696123412460922,
                     "topavgdiff@5": 1.3573907839616965}},
    "4x": {"train": {"ndcg@1": 0.8918526117807988,
                     "ndcg@3": 0.9151776743287706,
                     "ndcg@5": 0.9273341889273891,
                     "map@1": 0.9998005186515061,
                     "map@3": 0.9996841545315511,
                     "map@5": 0.99927854245628,
                     "topavg@1": 0.02333931777378815,
                     "topavg@3": 0.026664006915353346,
                     "topavg@5": 0.02976261719529226,
                     "topavgdiff@1": 1.6434270895671255,
                     "topavgdiff@3": 1.4804175809561806,
                     "topavgdiff@5": 1.3670855774985007}},
}
JAX_RANKING_METRIC["4y"] = JAX_RANKING_METRIC["4x"]
# The JAX package's train metrics on the cross-entropy paths (the held one
# first), taken on the CPU backend with chunked histogram sums by
#   JAX_PLATFORMS=cpu python scripts/jax_reference_auc.py \
#       --objective xentropy|xentlambda --growth MODE --hist-impl matmul
JAX_XENTROPY_METRIC = {
    "4z": {"xentropy": 0.6409453522604893, "kldiv": 0.1022243812843356},
    "4za": {"xentlambda": 0.6525149517965491},
}
# the row-sampling paths of phase 4 (#7): a growth mode, the parameters
# over PARAMS, the data (bench.py's binary workload or ``ranking_data``),
# the rounds, and whether a valid set of VALID_ROWS rows (seed 1) is kept.
# The valid set decides the JAX package's bagging key stream: without one
# ``lgb.train`` fuses the loop into blocks (``split(key, block + 1)``), with
# one it splits a key an iteration; DART and RF always take the latter.
# 4zb also stops early on the valid AUC
SAMPLING_PATHS = {
    "4zb": ("exact", {"bagging_fraction": 0.8, "bagging_freq": 1,
                      "metric": "auc"}, "dense", 5, True),
    "4zc": ("batched_part", {"bagging_fraction": 0.5, "bagging_freq": 2,
                             "feature_fraction": 0.8}, "dense", 5, False),
    "4zd": ("frontier", {"boosting": "goss", "top_rate": 0.2,
                         "other_rate": 0.1, "learning_rate": 0.25},
            "dense", 8, False),
    "4ze": ("batched", {"boosting": "dart", "drop_rate": 0.5,
                        "skip_drop": 0.0}, "dense", 8, True),
    "4zf": ("exact", {"boosting": "rf", "bagging_fraction": 0.632,
                      "bagging_freq": 1, "feature_fraction": 0.8},
            "dense", 5, True),
    "4zg": ("frontier", dict(RANKING_PARAMS, bagging_fraction=0.8,
                             bagging_freq=1), "ranking", 5, False),
}
# The JAX package's train AUC on each row-sampling path (on 4zb also its
# valid AUC after each iteration and its best iteration, on 4ze its drop
# sets; on 4zg its train ranking metrics), taken on the CPU backend with
# chunked histogram sums by
#   JAX_PLATFORMS=cpu python scripts/jax_reference_auc.py --hist-impl matmul \
#       --growth MODE --rounds R [--valid] [--boosting B] [--data ranking] \
#       [the path's --bagging-fraction, --bagging-freq, --feature-fraction,
#        --top-rate, --other-rate, --learning-rate, --drop-rate, --skip-drop]
JAX_SAMPLING_METRIC = {
    "4zb": {"auc": 0.9619187758590569,
            "valid": [0.9479986041386149,
                      0.9557844154484688,
                      0.9587165494502657,
                      0.9596871763480094,
                      0.9606972630084464],
            "best_iteration": 5},
    "4zc": {"auc": 0.9621497302252083},
    "4zd": {"auc": 0.9727381870505987},
    "4ze": {"auc": 0.9574801269889175,
            "drops": [[], [], [1], [0, 1], [0, 3], [0, 1, 2, 4],
                      [2, 3, 5], [0, 1, 4, 5]]},
    "4zf": {"auc": 0.9579133224967364},
    "4zg": {"train": {"ndcg@1": 0.8863469265623674,
                      "ndcg@3": 0.9007895782971747,
                      "ndcg@5": 0.9116234201042583,
                      "map@1": 0.9998005186515061,
                      "map@3": 0.9994846731830571,
                      "map@5": 0.9987956313584672,
                      "topavg@1": 0.00718132854578097,
                      "topavg@3": 0.015426557616862816,
                      "topavg@5": 0.020466786355475913,
                      "topavgdiff@1": 1.644225014961101,
                      "topavgdiff@3": 1.4712414389254596,
                      "topavgdiff@5": 1.3554957111510089},
            # the JAX package's forest parts from the port's plain run with
            # float64 sums at tree 1's node 110, where frontier growth's last
            # wave ranks two leaves' splits whose exact gains are 1.4e-4
            # apart, and the JAX package's float32 gain puts the lesser
            # first; taken on the CPU by
            #   JAX_PLATFORMS=cpu python scripts/gain_tie_probe.py --path 4zg
            "gain_tie": {"tree": 1, "node": 110,
                         "jax_exact": 76.86220149987639,
                         "jax_f32": 76.8818359375,
                         "port_exact": 76.87317600672668,
                         "port_f32": 76.8720703125}},
}
# the constraint paths of phase 4 (Queue 1 #4/#6): a growth mode and a kind
# each. "monotone" is objective=regression on ``regression_data`` with +1
# on feature 0 and -1 on feature 1 (against the data's x1*x2 term, so the
# bounds bind), through every grower; "forced" and "cegb" (exact growth
# only, as in the JAX package) are bench.py's binary workload, "forced"
# with FORCED_SPLITS written to a file, "cegb" with CEGB_PARAMS
CONSTRAINT_PATHS = {"4zh": ("exact", "monotone"),
                    "4zi": ("frontier", "monotone"),
                    "4zj": ("batched", "monotone"),
                    "4zk": ("batched_part", "monotone"),
                    "4zl": ("exact", "forced"),
                    "4zm": ("exact", "cegb")}
MONOTONE_CONSTRAINTS = [1, -1] + [0] * (NUM_FEATURES - 2)
# the root on feature 0 at 0.0; its left child on feature 1 at 0.0; its
# right child on feature 2 at 0.0, whose right child is on feature 3 at
# 0.5: four BFS steps, splitting leaves 0, 0, 1, 3
FORCED_SPLITS = {"feature": 0, "threshold": 0.0,
                 "left": {"feature": 1, "threshold": 0.0},
                 "right": {"feature": 2, "threshold": 0.0,
                           "right": {"feature": 3, "threshold": 0.5}}}
FORCED_STEPS = [(0, 0, 0.0), (0, 1, 0.0), (1, 2, 0.0), (3, 3, 0.5)]
# CEGB with bagging: features 0-7 free to buy and the rest too dear to buy,
# a small lazy cost a row on every feature, and the split penalty picked on
# the JAX package (scripts/jax_reference_auc.py --constraint cegb
# --cegb-penalty-split P): at 2 iterations 0.003 and 0.01 grow 255-leaf
# trees, 0.015 trees of 255 and 161 leaves, 0.02 of 23 and 12; at 5
# iterations 0.016 grows 57, 205, 11, 8, 4 leaves on features 0-7, 0.017
# grows 32, 22, 11, 4, 4 on features 0-3 and 0.018 31, 13, 4, 12, 4. 0.017
# ends every tree below num_leaves, on more than one feature, away from
# the jump to 205 leaves
CEGB_PARAMS = {"bagging_fraction": 0.8, "bagging_freq": 1,
               "cegb_tradeoff": 1.0, "cegb_penalty_split": 0.017,
               "cegb_penalty_feature_coupled": [0.0] * 8 + [1e7] * 20,
               "cegb_penalty_feature_lazy": [1e-4] * NUM_FEATURES}
# The JAX package's train l2 (monotone) or AUC on each constraint path, the
# splits of its 5 trees on features 0 and 1 (monotone), and (cegb) the
# leaves of its trees, the features its trees split on and its final
# feature_used, taken on the CPU backend with chunked histogram sums by
#   JAX_PLATFORMS=cpu python scripts/jax_reference_auc.py --hist-impl matmul \
#       --growth MODE --constraint monotone|forced|cegb
JAX_CONSTRAINT_METRIC = {
    "4zh": {"train": 1.5083580858663685, "splits_on": {"0": 220, "1": 116}},
    "4zi": {"train": 1.5085938773906162, "splits_on": {"0": 227, "1": 82}},
    "4zj": {"train": 1.5083254489283735, "splits_on": {"0": 223, "1": 108}},
    "4zk": {"train": 1.5083254994323076, "splits_on": {"0": 223, "1": 108}},
    "4zl": {"auc": 0.9717860122267304},
    "4zm": {"auc": 0.8583862264963518, "leaves": [32, 22, 11, 4, 4],
            "split_features": [0, 1, 2, 3], "feature_used": [0, 1, 2, 3]},
}
# the float64 paths of phase 4 (Queue 1 #3): exact growth with float64
# histograms, each on data phase 4 already binned: (the spelling of f64,
# the data, the f32 path of the same data and growth it is printed beside)
F64_PATHS = {"4zn": ({"gpu_use_dp": True}, "dense", "exact"),
             "4zo": ({"tpu_hist_dtype": "float64"}, "categorical", "4m"),
             "4zp": ({"gpu_use_dp": True}, "ranking", "4v")}
# The JAX package's train metrics on the f64 paths, taken on the CPU
# backend (its f64 histograms are an XLA scatter in float64 there, no
# drift) by
#   JAX_PLATFORMS=cpu python scripts/jax_reference_auc.py --gpu-use-dp
#   JAX_PLATFORMS=cpu python scripts/jax_reference_auc.py \
#       --hist-dtype float64 --data categorical
#   JAX_PLATFORMS=cpu python scripts/jax_reference_auc.py --gpu-use-dp \
#       --data ranking
JAX_F64_METRIC = {"4zn": {"auc": 0.9623968615768451},
                  "4zo": {"auc": 0.9201280032333901},
                  "4zp": {"ndcg@1": 0.8865863041805594,
                          "ndcg@3": 0.9125385135134905,
                          "ndcg@5": 0.9253591660621158}}
# f64 sums leave the trees no f32 gain tie to part at, so the train
# metrics are the JAX package's up to the rounding of f32 leaf values and
# the gradients' ulps: AUC absolute, ndcg relative. On the categorical
# data a one-vs-rest split and its mirror tie exactly in any precision; a
# mirror sends the same rows the same way, so the AUC does not see it
F64_AUC_TOL = 1e-5
F64_NDCG_REL_TOL = 1e-5
# path 4zq (Queue 1 #16): exact growth with PARAMS on the sparse CSR
# (``sparse_data``: MAIN_ROWS x 1,000, binned without densifying it). The
# JAX package's train AUC, taken on the CPU backend with float64 histogram
# sums (its f64 scatter, no drift; its chunked matmul sums build a
# [16,384, C, B] one-hot a chunk, which at this data's stored columns did
# not finish 100,000 rows in 20 minutes) by
#   JAX_PLATFORMS=cpu python scripts/jax_reference_auc.py --data sparse \
#       --gpu-use-dp
JAX_SPARSE_AUC = 0.5737745172051685
# 4zq's CSR predicted and densified block by block on its first
# SPARSE_PREDICT_ROWS rows (15 of predict's row blocks)
SPARSE_PREDICT_ROWS = 250_000
# path 4zr (#16): the first FILE_ROWS rows of the dense data as a CSV file
# (label in column 0, a header, values "%.17g") and LIBSVM_ROWS rows of the
# sparse data as a libsvm file; the binary cache of the whole dense Dataset
# trained DP_ROUNDS rounds under gpu_use_dp from memory and from the file
FILE_ROWS, LIBSVM_ROWS, DP_ROUNDS = 250_000, 100_000, 2
# path 4zs (#8): the prediction extras on models phase 4 trained: pred_leaf
# and pred_early_stop (margin 1e30) on every training row, the margin rule
# on EARLY_STOP_ROWS rows against a host emulation, pred_contrib on
# CONTRIB_ROWS rows and the plain recursion on CONTRIB_PLAIN_ROWS of them
EARLY_STOP_ROWS, CONTRIB_ROWS, CONTRIB_PLAIN_ROWS = 10_000, 10_000, 50
# 4zq's merged paths are ~50 deep, so its plain recursion takes 0.3-0.7 s a
# row on the host: 10 rows of it, to keep the whole run inside its limit
# with 4zt-4zw (50 rows took 13-37 s)
SPARSE_CONTRIB_PLAIN_ROWS = 10
EXTRAS_RAW_TOL = 1e-6          # raw scores, absolute (contrib: x max(1, |s|))
CONTRIB_PLAIN_REL = 1e-9       # of a row's sum of |contrib|, a class's
# path 4zt (#17): the estimators' trees, the rows predicted after a
# pickle round trip and the (tree, leaf) pairs read through
# get_leaf_output
SKLEARN_TREES, PICKLE_ROWS, LEAF_SAMPLE = 5, 10_000, 200
# path 4zu (#17): lgb.cv on 4a's rows, binary with metric=auc, CV_FOLDS
# stratified, shuffled folds (seed 0), CV_ROUNDS rounds, f32 exact. The
# JAX package's valid auc-mean and -stdv a round, taken on the CPU backend
# with float64 histogram sums (its f64 scatter; the chunked matmul takes
# 6-30 min a training at this size) by
#   JAX_PLATFORMS=cpu python scripts/jax_reference_auc.py --cv \
#       --gpu-use-dp --rounds 3
CV_FOLDS, CV_ROUNDS = 5, 3
JAX_CV_AUC = {"mean": [0.9482389596906508, 0.9552013695111171,
                       0.9583589241554312],
              "stdv": [0.0005112660269294178, 0.0008581770525645262,
                       0.0006395592446987079]}
# path 4zv (#17): the command line on 4zr's CSV, CLI_TREES trees; predict
# on CLI_PREDICT_ROWS rows, the C++ export on CPP_ROWS of them
CLI_TREES, CLI_PREDICT_ROWS, CPP_ROWS, CPP_REL_TOL = 5, 50_000, 1_000, 1e-6
# path 4zw (#20): RESET_ROUNDS rounds on the first half of 4a's rows, a
# reset to the second half, RESET_MORE_ROUNDS more; the JAX package's
# valid AUC after them, taken with its f64 scatter by
#   JAX_PLATFORMS=cpu python scripts/jax_reference_auc.py --reset \
#       --gpu-use-dp --rounds 3 --more-rounds 2
# (its reset adds the init-score offsets, 2.24e-4 here, to the replayed
# scores once more; the script takes them back out: ROADMAP Queue 3)
RESET_ROUNDS, RESET_MORE_ROUNDS = 3, 2
JAX_RESET_AUC = 0.9621367607899336
RESET_VALID_TOL, REPLAY_TOL = 1e-7, 1e-5
# monotone paths' predictions on a grid: MONO_GRID points along feature 0,
# then along feature 1, at each of MONO_GRID_ROWS training rows, must move
# the constraint's way within MONO_GRID_TOL
MONO_GRID, MONO_GRID_ROWS, MONO_GRID_TOL = 64, 100, 1e-6


def constraint_params(kind: str, directory: str) -> dict:
    """The parameters over PARAMS of a constraint path's kind; "forced"
    writes FORCED_SPLITS to a file in ``directory``."""
    if kind == "monotone":
        return {"objective": "regression",
                "monotone_constraints": MONOTONE_CONSTRAINTS}
    if kind == "forced":
        path = "%s/forced_splits.json" % directory
        with open(path, "w") as fh:
            json.dump(FORCED_SPLITS, fh)
        return {"forcedsplits_filename": path}
    return dict(CEGB_PARAMS)


def monotone_violation(predict, x: np.ndarray,
                       constraints=MONOTONE_CONSTRAINTS, grid: int = MONO_GRID,
                       rows: int = MONO_GRID_ROWS) -> float:
    """The largest step against ``constraints`` along ``grid`` values of
    each constrained feature (its 1st to 99th percentile), at each of the
    first ``rows`` rows of ``x``: 0 for a monotone model."""
    at = x[:rows]
    worst = 0.0
    for f, sign in enumerate(constraints):
        if sign == 0:
            continue
        values = np.linspace(*np.percentile(x[:, f], [1, 99]), grid)
        pts = np.repeat(at, grid, axis=0)
        pts[:, f] = np.tile(values, len(at))
        pred = np.asarray(predict(pts), np.float64).reshape(len(at), grid)
        worst = max(worst, float((-sign * np.diff(pred, axis=1)).max()))
    return worst


def forced_nodes(models, ds) -> list:
    """Each tree's nodes 0-3 as (split leaf, feature, threshold bin), and
    FORCED_STEPS the same way on ``ds``'s bin mappers."""
    want = [(leaf, f, ds.bin_mappers[f].value_to_bin(thr) - 1)
            for leaf, f, thr in FORCED_STEPS]
    got = [[(int(t.split_leaf[i]), int(t.split_feature[i]),
             int(t.threshold_bin[i])) for i in range(len(FORCED_STEPS))]
           for t in models]
    return got, want


def split_features(models) -> list:
    """The features the trees split on, sorted."""
    return sorted({int(f) for t in models
                   for f in t.split_feature[:t.num_leaves_actual - 1]})


# GOSS on path 4zd: the rows kept besides the top ones within this share of
# their expectation, (N - tops) * other_cnt / (N - top_cnt): each of the
# ~800,000 others is kept with probability 1/8, so one standard deviation
# is ~296 rows, 0.3% of the ~100,000 expected
GOSS_OTHERS_REL = 0.015
# the lambdarank gradient at MSLR-WEB30K's shape (31,531 queries of up to
# 1,251 docs, ~120 a query): held to a float64 per-query plain version on
# a sample of RANK_SCALE_SAMPLE queries and the longest one, each element
# within RANK_SCALE_REL of its query's sum of |g|
MSLR_QUERIES, MSLR_MAX_DOCS, MSLR_MEAN_DOCS = 31_531, 1_251, 120
RANK_SCALE_SAMPLE, RANK_SCALE_REL = 300, 1e-4
# float32 operations lambdarank's pairwise pass does a pair (i, j) of one
# query: the score and gain differences, |disc_i - disc_j| and its two
# products, the /(0.01 + |ds|) regulariser (3), the sigmoid lambda (exp and
# 3 more), its hessian factor (3), the two products with |ΔNDCG|, three
# selects and the row and column sums
LAMBDARANK_PAIR_OPS = 25

# histogram shapes of the main path: the root (K=3 over every row) and the
# fused two-child pass of a split (K=6) at the leaf sizes exact growth
# meets (its median split pass has ~7,400 rows)
HIST_SHAPES = [(1_000_000, 28, 255, 3), (512, 28, 255, 6),
               (4_096, 28, 255, 6), (16_384, 28, 255, 6),
               (65_536, 28, 255, 6), (262_144, 28, 255, 6)]
HIST_REL_TOL, HIST_ABS_TOL = 1e-5, 1e-6   # |d| <= rel * sum_bin|v| + abs
# a forced step's rebuild of one leaf (hist_for_leaf): (n, F, B, the leaf's
# rows), the leaf's range gathered with its sibling's
LEAF_SHAPES = [(1_000_000, 28, 255, 4_096), (1_000_000, 28, 255, 262_144)]
# slot histogram shapes (n, F, B, K, S): the frontier's waves at 255
# leaves (S = the wave's splits, from the first waves' 1 or 2 up to 254)
# and the batched step's parent-slot pass (K=6, S = tree_batch_splits =
# 16)
SLOT_SHAPES = [(1_000_000, 28, 255, 3, 2), (1_000_000, 28, 255, 3, 16),
               (1_000_000, 28, 255, 3, 128), (1_000_000, 28, 255, 3, 254),
               (1_000_000, 28, 255, 6, 16)]
SLOT_ACTIVE = 0.5             # share of rows in a slot
# packed bin words (tpu_bin_packing, ROADMAP Queue 1 #9): histogram.cu's
# word variant at the root of 4b's data, of one streamed chunk and of 34
# stored columns (9 words, 2 tail lanes) (n, C, B), and hist_slots.cu's at
# S = 16 over the same rows (n, C, B, S), SLOT_ACTIVE of the rows active;
# each beside the uint8 variant on the same codes
WORD_HIST_SHAPES = [(1_000_000, 28, 255), (131_072, 28, 255),
                    (1_000_000, 34, 255)]
WORD_SLOT_SHAPES = [(1_000_000, 28, 255, 16), (131_072, 28, 255, 16)]
# the partitioned-layout kernel on the layout of MAIN_ROWS rows at 255
# leaves: (label, S, share of the row-holding tiles active), the steps of a
# K=16 tree: A its first step, B the step where S reaches 16, C the middle
# steps, D the late ones (16 splits among 100+ leaves)
PART_SHAPES = [("A", 1, 1.0), ("B", 16, 1.0), ("C", 16, 0.5),
               ("D", 16, 0.125)]
# the in-tile partition: rows, width, tile, left share
REPACK_SHAPE = (1_048_576, 128, 512, 0.3)
MEM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
F64_OPS_PER_S = 34e12         # H100 SXM float64 outside the tensor cores
# histogram.cu's float64 variant (gpu_use_dp): the root and split passes of
# exact growth (n, F, B, K), each variant forced at each, and through
# hist_for_leaf at LEAF_SHAPES; |kernel - plain| <= rel * sum_bin|v| + abs
# against the plain version in float64, the count channel exact
F64_HIST_SHAPES = [(1_000_000, 28, 255, 3), (4_096, 28, 255, 6),
                   (262_144, 28, 255, 6)]
F64_HIST_REL_TOL, F64_HIST_ABS_TOL = 1e-12, 1e-300
L2_FLUSH_BYTES = 64 << 20     # more than the 50 MB L2


# "[part] " in a process of ``--part part``, so its lines can be told apart
LOG_PREFIX = ""


def log(msg: str) -> None:
    print(LOG_PREFIX + msg, flush=True)


def log_phase(t_start: float, name: str) -> None:
    """The seconds since ``t_start`` as phase ``name`` begins."""
    log("(%.1f s) %s" % (time.perf_counter() - t_start, name))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def regression_data(n: int, f: int = NUM_FEATURES, seed: int = 0):
    """bench.py's features and its target before the threshold
    (bench.py:162-165)."""
    r = np.random.RandomState(seed)
    x = r.randn(n, f).astype(np.float32)
    t = (x[:, 0] + x[:, 1] * x[:, 2] + 0.5 * np.sin(x[:, 3] * 3)
         + 0.3 * r.randn(n))
    return x, t


# path 4zz's nibble workload: NIBBLE_FEATURES numerical features of 2 to 16
# levels each (cycling), whose default layout pairs only the few whose bin
# counts multiply to at most the widest column's, and nibble pairs all
NIBBLE_FEATURES = 64


def small_bin_data(n: int, seed: int = 0, f: int = NIBBLE_FEATURES):
    """``f`` integer features of 2-16 levels (feature j has 2 + j % 15) and
    a label from eight of them and noise."""
    r = np.random.RandomState(seed)
    levels = 2 + np.arange(f) % 15
    x = np.floor(r.rand(n, f) * levels).astype(np.float32)
    t = (x[:, :8] / (levels[:8] - 1)) @ np.array(
        [1.0, -0.8, 0.6, 0.5, -0.4, 0.3, 0.3, -0.2]) + 0.3 * r.randn(n)
    return x, (t > np.median(t)).astype(np.float32)


def bench_data(n: int, f: int = NUM_FEATURES, seed: int = 0):
    """bench.py's workload (bench.py:162-165)."""
    x, t = regression_data(n, f, seed)
    return x, (t > 0).astype(np.float32)


def multiclass_data(n: int, seed: int = 0, num_class: int = 5):
    """bench.py's 28 features with ``regression_data``'s target cut at its
    own quantiles into ``num_class`` balanced classes 0..num_class-1."""
    x, t = regression_data(n, seed=seed)
    cuts = np.quantile(t, np.arange(1, num_class) / num_class)
    return x, np.searchsorted(cuts, t).astype(np.float32)


# the ranking workload: consecutive queries of RANK_DOCS docs (MSLR-WEB30K
# has ~120 a query), relevance 0-4 cut at the global quantiles
# RELEVANCE_CUTS so that most docs are irrelevant, as MSLR's are
RANK_DOCS = (50, 150)
RELEVANCE_CUTS = (0.5, 0.8, 0.95, 0.99)
QUERY_OFFSET_SD = 0.5


def ranking_data(n: int, seed: int = 0, docs=RANK_DOCS):
    """A learning-to-rank table: bench.py's 28 features and
    ``regression_data``'s target plus an N(0, QUERY_OFFSET_SD) offset a
    query (so a query's label mix varies, as a search engine's do), in
    consecutive queries of a uniform ``docs[0]``-``docs[1]`` docs (the last
    query takes the rows left over); relevance 0-4 is the shifted target
    cut at its global quantiles RELEVANCE_CUTS. Returns (x, rel, the
    queries' sizes)."""
    x, t = regression_data(n, seed=seed)
    r = np.random.RandomState([seed, 12])
    sizes = r.randint(docs[0], docs[1] + 1, n // docs[0] + 1)
    ends = np.cumsum(sizes)
    q = int(np.searchsorted(ends, n)) + 1
    sizes = sizes[:q].copy()
    sizes[-1] -= ends[q - 1] - n
    shifted = t + np.repeat(r.randn(q) * QUERY_OFFSET_SD, sizes)
    cuts = np.quantile(shifted, RELEVANCE_CUTS)
    return x, np.searchsorted(cuts, shifted).astype(np.float32), sizes


def xentropy_data(n: int, seed: int = 0):
    """bench.py's features with labels in [0, 1]: the sigmoid of
    ``regression_data``'s target, and weights uniform in [0.5, 1.5] (seed
    2) for the weighted path."""
    x, t = regression_data(n, seed=seed)
    w = np.random.RandomState(2).uniform(0.5, 1.5, n).astype(np.float32)
    return x, (1.0 / (1.0 + np.exp(-t))).astype(np.float32), w


# HIGGS's jet b-tag columns (0-based features 8, 12, 16, 20 of its 28) take
# three values; these are HIGGS's own, their shares this synthetic's choice
BTAG_FEATURES = (8, 12, 16, 20)
BTAG_VALUES = (0.0, 1.0865, 2.1731)
BTAG_SHARES = (0.5, 0.25, 0.25)
ONEHOT_GROUPS, ONEHOT_WIDTH = 8, 32


def bundled_data(n: int, seed: int = 0, groups: int = ONEHOT_GROUPS,
                 width: int = ONEHOT_WIDTH):
    """HIGGS with its b-tags plus one-hot categoricals: bench.py's 28
    standard-normal features with the four b-tag columns replaced by their
    three values, then ``groups`` one-hot blocks of ``width`` float32
    columns (a row has no category with probability 0.5, else one uniform
    over ``width``). The label thresholds bench.py's target plus the
    effects of the first four blocks' categories (drawn from seed 5) and
    of the first b-tag. Default binning bundles each block into one stored
    column (EFB) and pairs the b-tags two to a column."""
    r = np.random.RandomState(seed)
    x = r.randn(n, NUM_FEATURES).astype(np.float32)
    noise = r.randn(n)
    effects = np.random.RandomState(5)
    btag = np.asarray(BTAG_VALUES, np.float32)
    for j in BTAG_FEATURES:
        x[:, j] = btag[r.choice(3, n, p=BTAG_SHARES)]
    onehot = np.zeros((n, groups * width), np.float32)
    eff = np.zeros(n)
    rows = np.arange(n)
    for g in range(groups):
        cat = np.where(r.rand(n) < 0.5, -1, r.randint(0, width, n))
        has = cat >= 0
        onehot[rows[has], g * width + cat[has]] = 1.0
        if g < 4:
            eff += np.where(has, effects.randn(width)[np.maximum(cat, 0)],
                            0.0)
    y = (x[:, 0] + x[:, 1] * x[:, 2] + 0.5 * np.sin(3 * x[:, 3]) + eff
         + 0.4 * (x[:, 8] > 1) + 0.3 * noise > 0)
    return np.hstack([x, onehot]), y.astype(np.float32)


# the sparse workload of path 4zq (a scipy CSR, ROADMAP Queue 1 #16):
# one-hot blocks (one stored 1.0 a row a block) and sparse numeric columns
SPARSE_BLOCKS, SPARSE_WIDTH = 8, 100
SPARSE_NUMERIC, SPARSE_DENSITY = 200, 0.01


def sparse_data(n: int, seed: int = 0, blocks: int = SPARSE_BLOCKS,
                width: int = SPARSE_WIDTH, numeric: int = SPARSE_NUMERIC,
                density: float = SPARSE_DENSITY):
    """A sparse count or one-hot table, as a scipy CSR [n, blocks * width
    + numeric] float64 (at the defaults 1,000,000 x 1,000 with ~10M
    stored values, ~120 MB): ``blocks`` one-hot blocks of ``width``
    columns, one stored 1.0 a row a block (a category drawn uniformly),
    then ``numeric`` columns at ``density`` with lognormal values. The
    label is binary, drawn from a logistic of three one-hot columns and two
    numeric ones. Default binning bundles each one-hot block into one
    stored column (EFB); no stored value is 0."""
    import scipy.sparse
    r = np.random.RandomState(seed)
    cats = r.randint(0, width, (n, blocks))
    rows = [np.repeat(np.arange(n), blocks)]
    cols = [(cats + np.arange(blocks) * width).reshape(-1)]
    vals = [np.ones(n * blocks)]
    num = {}
    for j in range(numeric):
        at = np.unique(r.randint(0, n, r.binomial(n, density)))
        v = r.lognormal(0.0, 1.0, len(at))
        rows.append(at)
        cols.append(np.full(len(at), blocks * width + j))
        vals.append(v)
        if j < 2:
            num[j] = (at, v)
    t = (1.5 * (cats[:, 0] == 3) - 1.2 * (cats[:, 1] == 7)
         + 1.0 * (cats[:, 2] < 10) - 0.5)
    for j, (at, v) in num.items():
        t[at] += (0.8 if j == 0 else -0.8) * np.log(v)
    y = (r.rand(n) < 1.0 / (1.0 + np.exp(-t))).astype(np.float32)
    x = scipy.sparse.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, blocks * width + numeric))
    return x, y


# the categorical workload's id columns (features 28-31): (ids, Zipf
# exponent or None for uniform, the id space a rank is mapped into or None
# for the ids in order, the most popular ranks that carry an effect)
CAT_COLUMNS = ((3, None, None, 3), (24, None, None, 24),
               (1_000, 1.1, None, 1_000), (20_000, 1.1, 60_000, 500))
CATEGORICAL_FEATURES = [28, 29, 30, 31]
CAT_EFFECT_SD = 0.7


def categorical_data(n: int, seed: int = 0):
    """A click or fraud table with id columns, HIGGS-shaped otherwise:
    bench.py's 28 standard-normal features, then four integer-coded
    categorical columns (CAT_COLUMNS): 3 and 24 uniform ids, 1,000 ids
    Zipf(1.1) over the ids in order, and 20,000 ids Zipf(1.1) over ranks,
    each rank mapped to an id by a seed-fixed permutation of 0..59,999.
    The label thresholds bench.py's target (0.3 noise included) plus an
    N(0, 0.7) effect per category, drawn from seed 5, for the first three
    columns and for the last one's 500 most popular ranks."""
    r = np.random.RandomState(seed)
    x = r.randn(n, NUM_FEATURES).astype(np.float32)
    noise = r.randn(n)
    effects = np.random.RandomState(5)
    ids = np.zeros((n, len(CAT_COLUMNS)), np.float32)
    eff = np.zeros(n)
    for j, (k, zipf, space, with_effect) in enumerate(CAT_COLUMNS):
        if zipf is None:
            rank = r.randint(0, k, n)
        else:
            p = np.arange(1, k + 1, dtype=np.float64) ** -zipf
            rank = r.choice(k, n, p=p / p.sum())
        e = effects.randn(with_effect) * CAT_EFFECT_SD
        eff += np.where(rank < with_effect,
                        e[np.minimum(rank, with_effect - 1)], 0.0)
        ids[:, j] = (rank if space is None else
                     np.random.RandomState(11).permutation(space)[rank])
    y = (x[:, 0] + x[:, 1] * x[:, 2] + 0.5 * np.sin(3 * x[:, 3]) + eff
         + 0.3 * noise > 0)
    return np.hstack([x, ids]), y.astype(np.float32)


def categorical_splits(models) -> dict:
    """Splits of ``models`` (host trees of this port or of the JAX
    package), those on categorical features, those that send more than one
    category left, the widest raw bitset (32-bit words up to its last
    non-zero one) and the largest category id sent left."""
    out = {"splits": 0, "categorical": 0, "multi_category": 0,
           "widest_words": 0, "max_category": -1}
    for t in models:
        for i in range(t.num_leaves_actual - 1):
            out["splits"] += 1
            if not t.is_categorical[i]:
                continue
            words = np.ascontiguousarray(t.cat_bitset[i], np.uint32)
            ids = np.flatnonzero(np.unpackbits(words.view(np.uint8),
                                               bitorder="little"))
            out["categorical"] += 1
            out["multi_category"] += int(len(ids) > 1)
            if len(ids):
                out["widest_words"] = max(out["widest_words"],
                                          int(ids[-1]) // 32 + 1)
                out["max_category"] = max(out["max_category"], int(ids[-1]))
    return out


# path 4q: a custom objective on bench.py's data, evaluated by AUC
FOBJ_PARAMS = {"metric": "auc"}


def logistic_fobj(preds, train_data):
    """The binary logistic loss as a custom objective, in numpy: the
    gradient p - y and the hessian p (1 - p) of the raw scores."""
    y = np.asarray(train_data.get_label(), np.float64)
    p = 1.0 / (1.0 + np.exp(-np.asarray(preds, np.float64)))
    return p - y, p * (1.0 - p)


def splits_on_layout(models, ds) -> dict:
    """Splits of ``models`` on features that share a stored column of the
    binned dataset ``ds``: in an EFB bundle and in a packed pair."""
    feats = [int(f) for t in models
             for f in t.split_feature[:t.num_leaves_actual - 1]]
    bundled, packed = set(), set()
    for cols, is_packed in zip(ds.col_features, ds.col_packed):
        if len(cols) > 1:
            (packed if is_packed else bundled).update(cols)
    return {"splits": len(feats),
            "bundled": sum(f in bundled for f in feats),
            "packed": sum(f in packed for f in feats)}


def workload(objective: str, n: int):
    """The main path's rows and labels for ``objective``: bench.py's 0/1
    labels for binary, its target cut into NUM_CLASS classes for the
    multiclass objectives (``multiclass_data``), its target before the
    threshold otherwise."""
    if objective == "binary":
        return bench_data(n)
    if objective in MULTICLASS_OBJECTIVES:
        return multiclass_data(n)
    return regression_data(n)


def objective_params(objective: str) -> dict:
    """What an objective adds to PARAMS: for multiclass the class count and
    both multiclass metrics."""
    if objective in MULTICLASS_OBJECTIVES:
        return {"num_class": NUM_CLASS,
                "metric": "multi_logloss,multi_error"}
    return {}


def time_ms(fn, flush, reps: int = 20) -> float:
    """Median device time of one call, measured with CUDA events, with the
    L2 cache evicted before each call."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: int, ops: int, ops_per_s: float = F32_OPS_PER_S):
    """(bound ms, what bounds it): the larger of the bytes over the memory
    rate and the additions over the card's rate for their type (float32
    by default)."""
    by_bytes, by_ops = nbytes / MEM_BYTES_PER_S, ops / ops_per_s
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def host_ms(fn, reps: int = 200) -> float:
    """Wall time of one call in a run of back-to-back calls that ends in a
    synchronise: the wrapper's host time where that exceeds the device
    time, the device time otherwise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


# a kernel of core/csrc as the profiler names it: its function in the
# sources' anonymous namespace
OWN_KERNEL_KEY = re.compile(r"^(?:void )?\(anonymous namespace\)::(\w+)")


def device_split(fn, flush, reps: int = 10):
    """Mean device time of one call by launch, from torch.profiler:
    {kernel function of core/csrc or "memset": ms}, with the L2 evicted
    before each call (by a fill kernel of PyTorch's, which is not counted).
    None when the profiler recorded fewer of the port's kernels than
    calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.fill_(1.0)
            fn()
        torch.cuda.synchronize()
    split, kernels_seen = collections.Counter(), 0
    for a in prof.key_averages():
        if a.device_type != DeviceType.CUDA:
            continue
        own = OWN_KERNEL_KEY.match(a.key)
        if own:
            kernels_seen += a.count
            split[own.group(1)] += a.self_device_time_total / 1e3 / reps
        elif "Memset" in a.key:
            split["memset"] += a.self_device_time_total / 1e3 / reps
    if kernels_seen < reps:
        return None                   # the profiler lost events: not measured
    return dict(split)


def device_ms(fn, flush, reps: int = 10):
    """Mean device time of one call (the port's kernels and the memsets),
    from ``device_split``; None where that is not measured."""
    split = device_split(fn, flush, reps)
    return None if split is None else sum(split.values())


def fmt(ms) -> str:
    return "not measured" if ms is None else "%.4f" % ms


def fmt_split(split) -> str:
    return "not measured" if split is None else ", ".join(
        "%s %.4f" % kv for kv in sorted(split.items()))


def hist_inputs(r, n, f, b, k):
    """Bins and values as the main path stacks them (``stack_vals``): grad,
    hess and a 0/1 count channel, about 10% of the rows masked out; at K=6
    each row's triple goes to the left or the right child."""
    xb = r.randint(0, b, (n, f)).astype(np.uint8)
    m = (r.rand(n) < 0.9).astype(np.float32)
    vals = np.stack([r.randn(n) * m, r.rand(n) * m, m], axis=1)
    if k == 6:
        left = (r.rand(n) < 0.5)[:, None]
        vals = np.concatenate([vals * left, vals * ~left], axis=1)
    return xb, vals.astype(np.float32)


def check_histogram_kernel(dev, flush):
    """Phase 3: the histogram kernel against its plain version, each variant
    at every shape (the plan's choice is the one the main path runs)."""
    rows = []
    for n, f, b, k in HIST_SHAPES:
        xb_np, vals = hist_inputs(np.random.RandomState(n + k), n, f, b, k)
        xb = torch.as_tensor(xb_np, device=dev)
        v = torch.as_tensor(vals, device=dev)
        want = hist.hist_tile_vals(xb, v, b, "plain")
        absum = hist.hist_tile_vals(xb, v.abs(), b, "plain")
        picked = kernels.hist_launch_plan(
            n, f, b, k, torch.cuda.get_device_properties(dev)
            .multi_processor_count).variant
        err, variants = None, {}
        for variant in kernels.HIST_VARIANTS:
            def call(variant=variant):
                return kernels.build_histogram_cuda(xb, v, b, variant)
            got = call()
            torch.cuda.synchronize()
            d = (got - want).abs()
            bad = int((d > HIST_REL_TOL * absum + HIST_ABS_TOL).sum())
            counts_exact = torch.equal(got[..., 2::3], want[..., 2::3])
            if bad or not counts_exact:
                raise AssertionError(
                    "histogram kernel (%s) disagrees with the plain version "
                    "in %d cells at n=%d K=%d (count channel exact: %s)"
                    % (variant, bad, n, k, counts_exact))
            variants[variant] = {
                "ms": time_ms(call, flush),
                "device_ms": device_ms(call, flush)}
            if variant == picked:
                err = d
        flat = (xb.to(torch.int64)
                + torch.arange(f, device=dev) * b).reshape(-1)
        src = v.unsqueeze(1).expand(n, f, k).reshape(n * f, k).contiguous()

        def library():
            return torch.zeros((f * b, k), device=dev).index_add_(0, flat,
                                                                   src)
        bound_ms, bound_by = bound(kernels.hist_bytes(n, f, b, k), n * f * k)
        row = {
            "n": n, "F": f, "B": b, "K": k, "variant": picked,
            "max_abs_err": float(err.max()),
            # the plan's variant, as the main path calls it
            "ms": variants[picked]["ms"],
            "device_ms": variants[picked]["device_ms"],
            "host_ms": host_ms(lambda: kernels.build_histogram_cuda(xb, v,
                                                                    b)),
            "variants": variants,
            "plain_ms": time_ms(lambda: hist.hist_tile_vals(
                xb, v, b, "plain"), flush),
            "library_ms": time_ms(library, flush),
            "library_host_ms": host_ms(library),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        log("hist n=%d F=%d B=%d K=%d (%s): max_abs_err=%.3g, count channel "
            "exact, kernel %.4f ms (device %s, host %.4f; variants, event "
            "/ device ms: %s), plain %.4f ms, index_add_ %.4f ms (host "
            "%.4f), bound %.4f ms (%s)"
            % (n, f, b, k, picked, row["max_abs_err"], row["ms"],
               fmt(row["device_ms"]), row["host_ms"],
               ", ".join("%s %.4f / %s" % (name, t["ms"],
                                            fmt(t["device_ms"]))
                         for name, t in variants.items()),
               row["plain_ms"], row["library_ms"], row["library_host_ms"],
               row["bound_ms"], row["bound_by"]))
        rows.append(row)
        del xb, v, got, want, absum, flat, src, err, d
    return rows


def leaf_inputs(dev, n, f, b, leaf_rows):
    """A row partition of ``n`` rows (a random order) in which leaf 1 holds
    ``leaf_rows`` rows, and the range that a forced step gathers for it:
    its parent's, twice as long (leaf 1 its right half). Bins and values
    as ``hist_inputs`` makes them. Returns (partition, leaf [1], begin,
    count, xb, vals)."""
    r = np.random.RandomState(leaf_rows)
    xb, vals = hist_inputs(r, n, f, b, 3)
    begin = int(r.randint(0, n - 2 * leaf_rows))
    order = torch.as_tensor(r.permutation(n), device=dev)
    leaf_begin = torch.zeros(2, dtype=torch.int64, device=dev)
    leaf_begin[1] = begin + leaf_rows
    leaf_count = torch.full((2,), leaf_rows, dtype=torch.int64, device=dev)
    part = partition.RowPartition(order, leaf_begin, leaf_count)
    return (part, torch.ones(1, dtype=torch.int64, device=dev), begin,
            2 * leaf_rows, torch.as_tensor(xb, device=dev),
            torch.as_tensor(vals, device=dev))


def check_leaf_histogram(dev, flush):
    """Phase 3: ``hist_for_leaf`` (a forced split's rebuild of one leaf:
    gather its parent's range, zero the rows outside the leaf, one K=3
    pass of histogram.cu) against its plain version on 1,000,000 rows at
    each leaf size of LEAF_SHAPES, timed against its bound and one
    ``index_add_`` over the same gathered rows."""
    rows = []
    for n, f, b, leaf_rows in LEAF_SHAPES:
        part, leaf, begin, count, xb, v = leaf_inputs(dev, n, f, b,
                                                      leaf_rows)

        def call(impl="auto", vals=v):
            return partition.hist_for_leaf(part, leaf, begin, count, xb,
                                           vals, b, impl)
        want = call("plain")
        absum = call("plain", v.abs())
        got = call()
        torch.cuda.synchronize()
        d = (got - want).abs()
        bad = int((d > HIST_REL_TOL * absum + HIST_ABS_TOL).sum())
        idx = part.order[begin:begin + count]
        # the leaf's in-bag rows, each counted once in column 0's bins
        in_bag = float(v.index_select(0, idx[leaf_rows:])[:, 2].sum())
        if bad or not torch.equal(got[..., 2], want[..., 2]) \
                or float(got[0, :, 2].sum()) != in_bag:
            raise AssertionError("hist_for_leaf disagrees with its plain "
                                 "version in %d cells at a leaf of %d rows"
                                 % (bad, leaf_rows))
        inside = ((torch.arange(begin, begin + count, device=dev)
                   >= begin + leaf_rows)[:, None])
        src_rows = xb.index_select(0, idx)
        src_vals = torch.where(inside, v.index_select(0, idx), 0.0)
        flat = (src_rows.to(torch.int64)
                + torch.arange(f, device=dev) * b).reshape(-1)
        src = src_vals.unsqueeze(1).expand(count, f, 3).reshape(
            count * f, 3).contiguous()

        def library():
            return torch.zeros((f * b, 3), device=dev).index_add_(0, flat,
                                                                  src)
        # the function is the histogram of the leaf's rows: each of its row
        # ids, bin rows and value triples read once, the histogram written
        # once. The sibling's rows that the route gathers and zeroes are
        # its own cost (gathered_rows), left out of the bound
        nbytes = leaf_rows * 8 + kernels.hist_bytes(leaf_rows, f, b, 3)
        bound_ms, bound_by = bound(nbytes, leaf_rows * f * 3)
        row = {"n": n, "F": f, "B": b, "K": 3, "leaf_rows": leaf_rows,
               "gathered_rows": count, "max_abs_err": float(d.max()),
               "ms": time_ms(call, flush),
               "host_ms": host_ms(call),
               "plain_ms": time_ms(lambda: call("plain"), flush),
               "library_ms": time_ms(library, flush),
               "bound_ms": bound_ms, "bound_by": bound_by}
        log("hist_for_leaf n=%d F=%d B=%d K=3, leaf %d of %d gathered rows: "
            "max_abs_err=%.3g, count channel exact, kernel %.4f ms (host "
            "%.4f), plain %.4f ms, index_add_ %.4f ms, bound %.4f ms (%s)"
            % (n, f, b, leaf_rows, count, row["max_abs_err"], row["ms"],
               row["host_ms"], row["plain_ms"], row["library_ms"],
               row["bound_ms"], row["bound_by"]))
        rows.append(row)
        del part, xb, v, want, absum, got, d, src_rows, src_vals, flat, src
    return rows


def check_f64_result(got, want, absum, what: str) -> float:
    """Raises unless the f64 kernel's ``got`` is within F64_HIST_REL_TOL *
    sum_bin|v| + F64_HIST_ABS_TOL of the float64 plain ``want`` in every
    cell, its count channels exact; returns the largest difference."""
    if got.dtype != torch.float64:
        raise AssertionError("%s returned %s" % (what, got.dtype))
    d = (got - want).abs()
    bad = int((d > F64_HIST_REL_TOL * absum + F64_HIST_ABS_TOL).sum())
    counts_exact = torch.equal(got[..., 2::3], want[..., 2::3])
    if bad or not counts_exact:
        raise AssertionError("%s disagrees with the float64 plain version "
                             "in %d cells (count channel exact: %s)"
                             % (what, bad, counts_exact))
    return float(d.max())


def check_histogram_f64(dev, flush):
    """Phase 3: histogram.cu's float64 variant (``build_histogram_f64_cuda``,
    the wrapper exact growth calls under ``gpu_use_dp``) against the plain
    version in float64, each variant forced at each of F64_HIST_SHAPES
    (the plan's choice is the main path's), then through ``hist_for_leaf``
    at LEAF_SHAPES (``build_histogram_leaf_f64_cuda``); each timed against
    its bound (bytes n*F + 8*n*K + 8*F*B*K, or n*F*K float64 additions at
    F64_OPS_PER_S) and one float64 ``index_add_`` on a prebuilt index."""
    rows = []
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for n, f, b, k in F64_HIST_SHAPES:
        xb_np, vals = hist_inputs(np.random.RandomState(n + k), n, f, b, k)
        xb = torch.as_tensor(xb_np, device=dev)
        v = torch.as_tensor(vals.astype(np.float64), device=dev)
        want = hist.hist_tile_vals(xb, v, b, "plain")
        absum = hist.hist_tile_vals(xb, v.abs(), b, "plain")
        picked = kernels.hist_launch_plan(n, f, b, k, sm, None, 8)
        err, variants = None, {}
        for variant in kernels.HIST_VARIANTS:
            def call(variant=variant):
                return kernels.build_histogram_f64_cuda(xb, v, b, variant)
            got = call()
            torch.cuda.synchronize()
            e = check_f64_result(got, want, absum, "histogram f64 kernel "
                                 "(%s) at n=%d K=%d" % (variant, n, k))
            plan = kernels.hist_launch_plan(n, f, b, k, sm, variant, 8)
            variants[variant] = {"ms": time_ms(call, flush),
                                 "device_ms": device_ms(call, flush),
                                 "feature_tiles": plan.grid_x,
                                 "replicas": plan.replicas}
            if variant == picked.variant:
                err = e
        flat = (xb.to(torch.int64)
                + torch.arange(f, device=dev) * b).reshape(-1)
        src = v.unsqueeze(1).expand(n, f, k).reshape(n * f, k).contiguous()

        def library():
            return torch.zeros((f * b, k), dtype=torch.float64,
                               device=dev).index_add_(0, flat, src)
        bound_ms, bound_by = bound(kernels.hist_bytes(n, f, b, k, 8),
                                   n * f * k, F64_OPS_PER_S)
        row = {"n": n, "F": f, "B": b, "K": k, "dtype": "float64",
               "variant": picked.variant, "max_abs_err": err,
               "ms": variants[picked.variant]["ms"],
               "device_ms": variants[picked.variant]["device_ms"],
               "variants": variants,
               "plain_ms": time_ms(lambda: hist.hist_tile_vals(
                   xb, v, b, "plain"), flush),
               "library_ms": time_ms(library, flush),
               "bound_ms": bound_ms, "bound_by": bound_by}
        log("hist f64 n=%d F=%d B=%d K=%d (%s): max_abs_err=%.3g, count "
            "channel exact, kernel %.4f ms (variants, event / device ms, "
            "feature tiles x replicas: %s), plain %.4f ms, index_add_ f64 "
            "%.4f ms, bound %.4f ms (%s)"
            % (n, f, b, k, picked.variant, err, row["ms"],
               ", ".join("%s %.4f / %s, %d x %d" % (
                   name, t["ms"], fmt(t["device_ms"]), t["feature_tiles"],
                   t["replicas"]) for name, t in variants.items()),
               row["plain_ms"], row["library_ms"], bound_ms, bound_by))
        rows.append(row)
        del xb, v, got, want, absum, flat, src
    for n, f, b, leaf_rows in LEAF_SHAPES:
        part, leaf, begin, count, xb, v32 = leaf_inputs(dev, n, f, b,
                                                        leaf_rows)
        v = v32.double()
        before = (kernels.build_histogram_leaf_f64_cuda.launches,
                  kernels.build_histogram_f64_cuda.launches)

        def call(impl="auto", vals=v):
            return partition.hist_for_leaf(part, leaf, begin, count, xb,
                                           vals, b, impl)
        got = call()
        torch.cuda.synchronize()
        if (kernels.build_histogram_leaf_f64_cuda.launches,
                kernels.build_histogram_f64_cuda.launches) != (
                before[0] + 1, before[1]):
            raise AssertionError("hist_for_leaf in float64 did not go "
                                 "through the f64 leaf wrapper alone")
        err = check_f64_result(got, call("plain"), call("plain", v.abs()),
                               "hist_for_leaf f64 at a leaf of %d rows"
                               % leaf_rows)
        idx = part.order[begin:begin + count]
        inside = ((torch.arange(begin, begin + count, device=dev)
                   >= begin + leaf_rows)[:, None])
        src_rows = xb.index_select(0, idx)
        flat = (src_rows.to(torch.int64)
                + torch.arange(f, device=dev) * b).reshape(-1)
        src = torch.where(inside, v.index_select(0, idx), 0.0).unsqueeze(
            1).expand(count, f, 3).reshape(count * f, 3).contiguous()

        def library():
            return torch.zeros((f * b, 3), dtype=torch.float64,
                               device=dev).index_add_(0, flat, src)
        nbytes = leaf_rows * 8 + kernels.hist_bytes(leaf_rows, f, b, 3, 8)
        bound_ms, bound_by = bound(nbytes, leaf_rows * f * 3, F64_OPS_PER_S)
        row = {"n": n, "F": f, "B": b, "K": 3, "dtype": "float64",
               "route": "hist_for_leaf", "leaf_rows": leaf_rows,
               "gathered_rows": count, "max_abs_err": err,
               "ms": time_ms(call, flush),
               "plain_ms": time_ms(lambda: call("plain"), flush),
               "library_ms": time_ms(library, flush),
               "bound_ms": bound_ms, "bound_by": bound_by}
        log("hist_for_leaf f64 n=%d F=%d B=%d K=3, leaf %d of %d gathered "
            "rows: max_abs_err=%.3g, count channel exact, kernel %.4f ms, "
            "plain %.4f ms, index_add_ f64 %.4f ms, bound %.4f ms (%s)"
            % (n, f, b, leaf_rows, count, err, row["ms"], row["plain_ms"],
               row["library_ms"], bound_ms, bound_by))
        rows.append(row)
        del part, xb, v, v32, got, flat, src, src_rows
    return rows


def slot_inputs(dev, n, f, b, k, s, xb=None):
    """Bins (``xb``, or uniform ones), slots with SLOT_ACTIVE of the rows
    active (slot S // 2 absent where S > 2), values as the main path
    stacks them (grad, hess and a count channel of ones) and a go-left
    selector, made with numpy from a seed."""
    r = np.random.RandomState(n + 7 * s + k)
    if xb is None:
        xb = r.randint(0, b, (n, f)).astype(np.uint8)
    slot = r.randint(0, s, n).astype(np.int32)
    if s > 2:
        slot[slot == s // 2] = s - 1
    slot[r.rand(n) >= SLOT_ACTIVE] = -1
    vals = np.stack([r.randn(n), r.rand(n), np.ones(n)], axis=1)
    sel = (r.rand(n) < 0.5).astype(np.float32)
    return [torch.as_tensor(a, device=dev)
            for a in (xb, slot, vals.astype(np.float32), sel)]


def slot_call(kern, xb, slot, v, sel, b, s, k):
    """One call of the K=3 or K=6 slot wrapper of ``kern`` (a kernels
    module: this checkout's, or another's when comparing two)."""
    if k == 3:
        return kern.build_histogram_slots_cuda(xb, slot, v, b, s)
    return kern.build_histogram_slots6_cuda(xb, slot, sel, v, b, s)


def slot_plain(xb, slot, v, sel, b, s, k):
    if k == 3:
        return hist.hist_slots(xb, slot, v, b, s, "plain")
    return hist.hist_slots6(xb, slot, sel, v, b, s, "plain")


def check_slot_result(got, want, absum, s, k) -> float:
    """Raises unless |got - want| <= 1e-5 * sum|v| + 1e-6 in every cell,
    the count channels are exact and (S > 2) slot S // 2 is zero; returns
    the largest difference."""
    err = (got - want).abs()
    bad = int((err > HIST_REL_TOL * absum + HIST_ABS_TOL).sum())
    counts_exact = torch.equal(got[..., 2::3], want[..., 2::3])
    absent = s > 2 and bool(got[s // 2].any())
    if bad or not counts_exact or absent:
        raise AssertionError("slot kernel K=%d disagrees with the plain "
                             "version in %d cells at S=%d (count channel "
                             "exact: %s, absent slot nonzero: %s)"
                             % (k, bad, s, counts_exact, absent))
    return float(err.max())


def slot_library(xb, slot, v, sel, b, s, k):
    """The library yardstick of a slot shape: one index_add_ over a
    prebuilt combined (slot, feature, bin) index of the active rows.
    Returns the call and the active-row count."""
    f, dev = xb.shape[1], xb.device
    src_rows = v if k == 3 else torch.cat(
        [v * sel[:, None], v * (1 - sel[:, None])], dim=1)
    act = torch.nonzero(slot >= 0).squeeze(1)
    n_active = int(act.numel())
    flat = ((slot.index_select(0, act).to(torch.int64)[:, None] * f
             + torch.arange(f, device=dev)) * b
            + xb.index_select(0, act).to(torch.int64)).reshape(-1)
    src = src_rows.index_select(0, act).unsqueeze(1).expand(
        n_active, f, k).reshape(-1, k).contiguous()

    def library():
        return torch.zeros((s * f * b, k), device=dev).index_add_(0, flat,
                                                                   src)
    return library, n_active


def check_slot_kernels(dev, flush):
    """Phase 3: both slot kernels against their plain versions
    (``slot_inputs``), each timed with events, by launch with the profiler,
    and back to back on the host."""
    rows = []
    for n, f, b, k, s in SLOT_SHAPES:
        xb, slot, v, sel = slot_inputs(dev, n, f, b, k, s)

        def kernel():
            return slot_call(kernels, xb, slot, v, sel, b, s, k)

        def plain(vals=v):
            return slot_plain(xb, slot, vals, sel, b, s, k)
        got, want, absum = kernel(), plain(), plain(v.abs())
        torch.cuda.synchronize()
        max_err = check_slot_result(got, want, absum, s, k)
        library, n_active = slot_library(xb, slot, v, sel, b, s, k)
        bound_ms, bound_by = bound(
            kernels.slot_hist_bytes(n, n_active, f, b, k, s),
            n_active * f * k)
        split = device_split(kernel, flush)
        row = {
            "n": n, "active": n_active, "F": f, "B": b, "K": k, "S": s,
            "max_abs_err": max_err,
            "ms": time_ms(kernel, flush),
            "device_ms": None if split is None else sum(split.values()),
            "device_split": split,
            "host_ms": host_ms(kernel),
            "plain_ms": time_ms(plain, flush),
            "library_ms": time_ms(library, flush),
            "library_host_ms": host_ms(library),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        log("slots n=%d active=%d F=%d B=%d K=%d S=%d: max_abs_err=%.3g, "
            "count channel exact, kernel %.4f ms (device %s: %s; host "
            "%.4f), plain %.4f ms, index_add_ %.4f ms (host %.4f), bound "
            "%.4f ms (%s)" % (n, n_active, f, b, k, s, max_err, row["ms"],
                              fmt(row["device_ms"]), fmt_split(split),
                              row["host_ms"], row["plain_ms"],
                              row["library_ms"], row["library_host_ms"],
                              bound_ms, bound_by))
        rows.append(row)
        del xb, slot, v, sel, got, want, absum, library
    return rows


def check_word_kernels(dev, flush):
    """Phase 3: the packed-word variants of histogram.cu and hist_slots.cu
    (``build_histogram_words_cuda``, ``build_histogram_slots_words_cuda``)
    against their plain versions (the words unpacked, then the plain sums)
    at WORD_HIST_SHAPES and WORD_SLOT_SHAPES, each timed beside the uint8
    variant on the same codes, one ``index_add_`` over the unpacked codes
    and its bound (the words' bytes: ld = 4 W a row). Returns (histogram
    rows, slot rows)."""
    hist_rows, slot_rows = [], []
    for n, c, b in WORD_HIST_SHAPES:
        xb_np, vals = hist_inputs(np.random.RandomState(n + c), n, c, b, 3)
        words = torch.as_tensor(binpack.pack_words_np(xb_np), device=dev)
        xb = torch.as_tensor(xb_np, device=dev)
        v = torch.as_tensor(vals, device=dev)
        ld = 4 * words.shape[1]

        def kernel():
            return kernels.build_histogram_words_cuda(words, v, b, c)
        got = kernel()
        want = hist.hist_tile_vals(words, v, b, "plain", packed_cols=c)
        absum = hist.hist_tile_vals(words, v.abs(), b, "plain",
                                    packed_cols=c)
        torch.cuda.synchronize()
        d = (got - want).abs()
        bad = int((d > HIST_REL_TOL * absum + HIST_ABS_TOL).sum())
        if bad or not torch.equal(got[..., 2], want[..., 2]):
            raise AssertionError("histogram kernel on words disagrees with "
                                 "the plain version in %d cells at n=%d "
                                 "C=%d" % (bad, n, c))
        flat = (xb.to(torch.int64)
                + torch.arange(c, device=dev) * b).reshape(-1)
        src = v.unsqueeze(1).expand(n, c, 3).reshape(n * c, 3).contiguous()

        def library():
            return torch.zeros((c * b, 3), device=dev).index_add_(0, flat,
                                                                   src)
        bound_ms, bound_by = bound(kernels.hist_bytes(n, c, b, 3, ld=ld),
                                   n * c * 3)
        row = {"n": n, "F": c, "ld": ld, "B": b, "K": 3,
               "variant": kernels.hist_launch_plan(
                   n, c, b, 3, torch.cuda.get_device_properties(dev)
                   .multi_processor_count, ld=ld).variant,
               "max_abs_err": float(d.max()), "ms": time_ms(kernel, flush),
               "u8_ms": time_ms(lambda: kernels.build_histogram_cuda(
                   xb, v, b), flush),
               "plain_ms": time_ms(lambda: hist.hist_tile_vals(
                   words, v, b, "plain", packed_cols=c), flush),
               "library_ms": time_ms(library, flush),
               "bound_ms": bound_ms, "bound_by": bound_by}
        log("hist on words n=%d C=%d (ld %d bytes, %s): max_abs_err=%.3g, "
            "count channel exact, kernel %.4f ms, uint8 variant %.4f ms, "
            "plain %.4f ms, index_add_ %.4f ms, bound %.4f ms (%s)"
            % (n, c, ld, row["variant"], row["max_abs_err"], row["ms"],
               row["u8_ms"], row["plain_ms"], row["library_ms"], bound_ms,
               bound_by))
        hist_rows.append(row)
        del words, xb, v, got, want, absum, d, flat, src
    for n, c, b, s in WORD_SLOT_SHAPES:
        xb, slot, v, _ = slot_inputs(dev, n, c, b, 3, s)
        words = torch.as_tensor(binpack.pack_words_np(xb.cpu().numpy()),
                                device=dev)
        ld = 4 * words.shape[1]

        def kernel():
            return kernels.build_histogram_slots_words_cuda(words, slot, v, b,
                                                            s, c)

        def plain(vals=v):
            return hist.hist_slots(words, slot, vals, b, s, "plain",
                                   packed_cols=c)
        got, want, absum = kernel(), plain(), plain(v.abs())
        torch.cuda.synchronize()
        max_err = check_slot_result(got, want, absum, s, 3)
        library, n_active = slot_library(xb, slot, v, None, b, s, 3)
        bound_ms, bound_by = bound(
            kernels.slot_hist_bytes(n, n_active, c, b, 3, s, ld=ld),
            n_active * c * 3)
        row = {"n": n, "active": n_active, "F": c, "ld": ld, "B": b, "K": 3,
               "S": s, "max_abs_err": max_err, "ms": time_ms(kernel, flush),
               "u8_ms": time_ms(lambda: kernels.build_histogram_slots_cuda(
                   xb, slot, v, b, s), flush),
               "plain_ms": time_ms(plain, flush),
               "library_ms": time_ms(library, flush),
               "bound_ms": bound_ms, "bound_by": bound_by}
        log("slots on words n=%d active=%d C=%d (ld %d bytes) S=%d: "
            "max_abs_err=%.3g, count channel exact, kernel %.4f ms, uint8 "
            "variant %.4f ms, plain %.4f ms, index_add_ %.4f ms, bound "
            "%.4f ms (%s)" % (n, n_active, c, ld, s, max_err, row["ms"],
                              row["u8_ms"], row["plain_ms"],
                              row["library_ms"], bound_ms, bound_by))
        slot_rows.append(row)
        del xb, slot, v, words, got, want, absum, library
    return hist_rows, slot_rows


def part_layout(r, n, num_leaves, f, b, n_slots, share=0.5):
    """A partitioned layout of ``n`` rows at ``num_leaves`` leaves, made with
    numpy: ``share`` of the row-holding tiles in contiguous runs of every
    slot but S // 2 (of as many slots as there are such tiles), an inactive
    tile after each run, each run ending in zero-valued segment padding.
    Values as the main path stacks them: grad, hess and a count channel of
    ones, all zero on the padding. Returns numpy (xb_fm, sel, vals3,
    tile_slot, tile_first) and the row tile."""
    tile = grow_batched_part.PART_TILE
    np_ = grow_batched_part._part_capacity(n, num_leaves, tile)
    n_tiles = np_ // tile
    xb_fm = r.randint(0, b, (f, np_)).astype(np.uint8)
    sel = (r.rand(np_) < 0.5).astype(np.float32)
    vals3 = np.stack([r.randn(np_), r.rand(np_),
                      np.ones(np_)]).astype(np.float32)
    active = max(1, int(round(-(-n // tile) * share)))
    owners = [s for s in r.permutation(n_slots) if s != n_slots // 2
              or n_slots <= 2][:active]
    cuts = np.sort(r.choice(np.arange(1, active), len(owners) - 1,
                            replace=False))
    bounds = np.concatenate([[0], cuts, [active]]).astype(int)
    tile_slot = np.full(n_tiles, -1, np.int32)
    t = 0
    for s, a, z in zip(owners, bounds[:-1], bounds[1:]):
        tile_slot[t:t + z - a] = s
        end = (t + z - a) * tile
        vals3[:, end - r.randint(1, tile):end] = 0.0
        t += z - a + 1
    prev = np.concatenate([[-2], tile_slot[:-1]])
    first = ((tile_slot >= 0) & (tile_slot != prev)).astype(np.int32)
    return (xb_fm, sel, vals3, tile_slot, first), tile


def part_inputs(dev, s, share, stored=None):
    """chip_smoke's part layout of MAIN_ROWS rows at 255 leaves on ``dev``:
    torch (xb_fm, sel, vals3, tile_slot, tile_first) and the row tile.
    With ``stored`` ([MAIN_ROWS, C] uint8) the layout's bins are its rows,
    repeated over the padded layout, instead of uniform ones."""
    f = NUM_FEATURES if stored is None else stored.shape[1]
    arrays, tile = part_layout(np.random.RandomState(11 + s), MAIN_ROWS, 255,
                               f, 255, s, share)
    if stored is not None:
        np_ = arrays[0].shape[1]
        arrays = (np.ascontiguousarray(
            stored[np.arange(np_) % len(stored)].T),) + tuple(arrays[1:])
    return [torch.as_tensor(a, device=dev) for a in arrays], tile


def part_call(kern, inputs, b, s, tile):
    """One call of the part wrapper of ``kern`` (a kernels module: this
    checkout's, or another's when comparing two)."""
    return kern.build_histogram_part_tiles_cuda(*inputs, b, s, tile)


def part_plain(inputs, b, s, tile, vals=None):
    xb_fm, sel, vals3, tile_slot, first = inputs
    return hist.hist_part_tiles(xb_fm, sel, vals3 if vals is None else vals,
                                tile_slot, first, b, s, tile, "plain")


def check_part_result(got, want, absum, tile_slot, s) -> float:
    """Raises unless |got - want| <= 1e-5 * sum|v| + 1e-6 in every cell,
    the count channels are exact and every slot that owns no tile (S // 2
    where S > 2) is zero; returns the largest difference."""
    err = (got - want).abs()
    bad = int((err > HIST_REL_TOL * absum + HIST_ABS_TOL).sum())
    counts_exact = torch.equal(got[..., 2::3], want[..., 2::3])
    owned = torch.zeros(s, dtype=torch.bool, device=got.device)
    owned[tile_slot[tile_slot >= 0].clamp(max=s - 1).long()] = True
    absent = bool(got[~owned].any())
    if bad or not counts_exact or absent:
        raise AssertionError("part kernel disagrees with the plain version "
                             "in %d cells at S=%d (count channel exact: %s, "
                             "absent slot nonzero: %s)"
                             % (bad, s, counts_exact, absent))
    return float(err.max())


def part_library(inputs, b, s, tile):
    """The library yardstick of a part shape: one index_add_ over a prebuilt
    combined (slot, child, feature, bin) index of the active tiles' rows.
    Returns the call, the active tiles and the active rows."""
    xb_fm, sel, vals3, tile_slot, _ = inputs
    f, dev = xb_fm.shape[0], xb_fm.device
    row_slot = tile_slot.to(torch.int64).repeat_interleave(tile)
    act = torch.nonzero(row_slot >= 0).squeeze(1)
    n_act = int(act.numel())
    child = (sel.index_select(0, act) == 0).to(torch.int64)
    flat = (((row_slot.index_select(0, act) * 2 + child)[:, None] * f
             + torch.arange(f, device=dev)) * b
            + xb_fm.index_select(1, act).t().to(torch.int64)).reshape(-1)
    src = vals3.index_select(1, act).t().unsqueeze(1).expand(
        n_act, f, 3).reshape(-1, 3).contiguous()

    def library():
        return torch.zeros((2 * s * f * b, 3), device=dev).index_add_(
            0, flat, src)
    return library, int((tile_slot >= 0).sum()), n_act


def check_part_kernel(dev, flush):
    """Phase 3: the partitioned-layout kernel against its plain version at
    each of PART_SHAPES, timed with events, by launch with the profiler,
    and back to back on the host."""
    rows = []
    f, b = NUM_FEATURES, 255
    for label, s, share in PART_SHAPES:
        inputs, tile = part_inputs(dev, s, share)

        def kernel():
            return part_call(kernels, inputs, b, s, tile)

        def plain(vals=None):
            return part_plain(inputs, b, s, tile, vals)
        got, want, absum = kernel(), plain(), plain(inputs[2].abs())
        torch.cuda.synchronize()
        max_err = check_part_result(got, want, absum, inputs[3], s)
        library, active_tiles, n_act = part_library(inputs, b, s, tile)
        n_tiles = int(inputs[3].numel())
        bound_ms, bound_by = bound(
            kernels.part_hist_bytes(active_tiles, n_tiles, tile, f, b, s),
            n_act * f * 6)
        split = device_split(kernel, flush)
        row = {
            "shape": label, "Np": int(inputs[0].shape[1]), "tiles": n_tiles,
            "active_tiles": active_tiles, "F": f, "B": b, "S": s,
            "max_abs_err": max_err,
            "ms": time_ms(kernel, flush),
            "device_ms": None if split is None else sum(split.values()),
            "device_split": split,
            "host_ms": host_ms(kernel),
            "plain_ms": time_ms(plain, flush),
            "library_ms": time_ms(library, flush),
            "library_host_ms": host_ms(library),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        log("part %s Np=%d tiles=%d active=%d F=%d B=%d S=%d: "
            "max_abs_err=%.3g, count channel exact, kernel %.4f ms (device "
            "%s: %s; host %.4f), plain %.4f ms, index_add_ %.4f ms (host "
            "%.4f), bound %.4f ms (%s)"
            % (label, row["Np"], n_tiles, active_tiles, f, b, s, max_err,
               row["ms"], fmt(row["device_ms"]), fmt_split(split),
               row["host_ms"], row["plain_ms"], row["library_ms"],
               row["library_host_ms"], bound_ms, bound_by))
        rows.append(row)
        del inputs, got, want, absum, library
    return rows


def check_partition_kernel(dev, flush):
    """Phase 3: the in-tile partition against its plain version, byte for
    byte."""
    n, c, tile, p_left = REPACK_SHAPE
    r = np.random.RandomState(13)
    rows = torch.as_tensor(r.randint(0, 256, (n, c)).astype(np.uint8),
                           device=dev)
    gl = torch.as_tensor(r.rand(n) < p_left, device=dev)

    def kernel():
        return kernels.partition_tiles_cuda(rows, gl, tile)

    def plain():
        return repack.partition_tiles(rows, gl, tile, "plain")
    (got, got_cnt), (want, want_cnt) = kernel(), plain()
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and torch.equal(got_cnt, want_cnt)):
        raise AssertionError("partition kernel is not byte-equal to the "
                             "plain version")
    # the library yardstick: the gather the JAX grower moves rows with, on
    # a prebuilt permutation (each tile's go-left rows first, stably)
    key = torch.arange(n, device=dev) // tile * 2 + (~gl).to(torch.int64)
    perm = torch.argsort(key, stable=True)
    if not torch.equal(rows.index_select(0, perm), want):
        raise AssertionError("the yardstick's permutation is not the "
                             "partition")
    bound_ms, bound_by = bound(kernels.partition_bytes(n, c, tile), 0)
    row = {"n": n, "C": c, "row_tile": tile, "p_left": p_left,
           "max_abs_err": 0.0,
           "ms": time_ms(kernel, flush), "plain_ms": time_ms(plain, flush),
           "library_ms": time_ms(lambda: rows.index_select(0, perm), flush),
           "bound_ms": bound_ms, "bound_by": bound_by}
    log("partition n=%d C=%d tile=%d: byte-equal, kernel %.4f ms, plain "
        "%.4f ms, index_select %.4f ms, bound %.4f ms (%s)"
        % (n, c, tile, row["ms"], row["plain_ms"], row["library_ms"],
           bound_ms, bound_by))
    return [row]


def plan_lines(n: int, c: int, b: int, sm: int) -> dict:
    """Each histogram kernel's plan at ``n`` rows over ``c`` stored columns
    of ``b`` bins, by wrapper: feature tiles, replicas, shared bytes."""
    root = kernels.hist_launch_plan(n, c, b, 3, sm)
    split = kernels.hist_launch_plan(max(n // 4, 1), c, b, 6, sm)
    slots3 = kernels.slot_hist_launch_plan(n, c, b, 3, BUNDLED_SLOTS, sm)
    slots6 = kernels.slot_hist_launch_plan(n, c, b, 6, BUNDLED_SLOTS, sm)
    tiles = grow_batched_part._part_capacity(n, 255,
                                             grow_batched_part.PART_TILE)
    part = kernels.part_hist_launch_plan(
        tiles // grow_batched_part.PART_TILE, c, b, sm)

    def one(p, replicas):
        return {"feature_tiles": p.grid_x if isinstance(p, kernels.HistPlan)
                else p.tiles, "feature_tile": p.feature_tile,
                "replicas": replicas, "smem_bytes": p.smem_bytes}
    return {"build_histogram_cuda": {
                "K=3 root": one(root, root.replicas),
                "K=6 exact's split passes (block)": one(split,
                                                        split.replicas)},
            "build_histogram_slots_cuda": {"K=3": one(slots3,
                                                      slots3.replicas)},
            "build_histogram_slots6_cuda": {"K=6": one(slots6,
                                                       slots6.replicas)},
            "build_histogram_part_tiles_cuda": {"K=6": one(part, 1)}}


def held_to_f64(got, want64, absum64, what: str) -> float:
    """Raises unless |got - want| <= 1e-5 * sum|v| + 1e-6 in every cell
    against the plain version computed in float64, with the count channels
    exact; returns the largest difference."""
    err = (got.double() - want64).abs()
    bad = int((err > HIST_REL_TOL * absum64 + HIST_ABS_TOL).sum())
    counts_exact = torch.equal(got[..., 2::3].double(), want64[..., 2::3])
    if bad or not counts_exact:
        raise AssertionError("%s disagrees with its plain version on the "
                             "stored matrix in %d cells (count channel "
                             "exact: %s)" % (what, bad, counts_exact))
    return float(err.max())


def check_stored_kernels(dev, flush, stored: np.ndarray, data: str,
                         root_only: bool = False):
    """Phase 3 on a workload's stored matrix (``stored`` [N, C] uint8, N =
    MAIN_ROWS; ``data`` names it): the root pass (histogram.cu, K=3) and,
    unless ``root_only``, the slot kernels at S = BUNDLED_SLOTS with half
    the rows active (K=3 and K=6) and the partitioned-layout pass at S =
    BUNDLED_SLOTS with every tile active. Each is held to its plain
    version in float64, timed with events against the f32 plain version,
    its bound and one index_add_; returns {kernel: [row]}."""
    n, c = stored.shape
    b = 255
    xb = torch.as_tensor(stored, device=dev)
    skew = float((xb == 0).double().mean())
    out = {}

    def finish(name, label, row, max_err, kernel, plain, library, nbytes,
               ops):
        bound_ms, bound_by = bound(nbytes, ops)
        row.update(data=data, max_abs_err=max_err,
                   ms=time_ms(kernel, flush), plain_ms=time_ms(plain, flush),
                   library_ms=time_ms(library, flush), bound_ms=bound_ms,
                   bound_by=bound_by, share_at_bin0=skew)
        log("%s %s (%s): max_abs_err=%.3g against float64, count channel "
            "exact, kernel %.4f ms, plain %.4f ms, index_add_ %.4f ms, bound "
            "%.4f ms (%s); %.3f of the stored bytes are 0"
            % (data, name, label, max_err, row["ms"], row["plain_ms"],
               row["library_ms"], bound_ms, bound_by, skew))
        out[name] = [row]

    # ---- histogram.cu: the root, every row, K=3 ------------------------
    r = np.random.RandomState(21)
    m = (r.rand(n) < 0.9).astype(np.float32)
    v = torch.as_tensor(np.stack([r.randn(n) * m, r.rand(n) * m, m],
                                 axis=1).astype(np.float32), device=dev)
    got = kernels.build_histogram_cuda(xb, v, b)
    max_err = held_to_f64(got, hist.hist_tile_vals(xb, v.double(), b,
                                                   "plain"),
                          hist.hist_tile_vals(xb, v.double().abs(), b,
                                              "plain"), "histogram.cu")
    flat = (xb.to(torch.int64) + torch.arange(c, device=dev) * b).reshape(-1)
    src = v.unsqueeze(1).expand(n, c, 3).reshape(n * c, 3).contiguous()
    finish("histogram", "root %d x %d, K=3" % (n, c),
           {"n": n, "C": c, "B": b, "K": 3}, max_err,
           lambda: kernels.build_histogram_cuda(xb, v, b),
           lambda: hist.hist_tile_vals(xb, v, b, "plain"),
           lambda: torch.zeros((c * b, 3), device=dev).index_add_(0, flat,
                                                                  src),
           kernels.hist_bytes(n, c, b, 3), n * c * 3)
    del v, got, flat, src
    if root_only:
        return out

    # ---- hist_slots.cu: S = 16, half the rows active, K=3 and K=6 ------
    s = BUNDLED_SLOTS
    for k, name in ((3, "hist_slots"), (6, "hist_slots6")):
        _, slot, v, sel = slot_inputs(dev, n, c, b, k, s, xb=stored)
        got = slot_call(kernels, xb, slot, v, sel, b, s, k)
        want64 = slot_plain(xb, slot, v.double(), sel, b, s, k)
        absum64 = slot_plain(xb, slot, v.double().abs(), sel, b, s, k)
        max_err = held_to_f64(got, want64, absum64, "hist_slots.cu K=%d" % k)
        if bool(got[s // 2].any()):
            raise AssertionError("slot kernel K=%d: an absent slot is not "
                                 "zero at the bundled shape" % k)
        library, n_active = slot_library(xb, slot, v, sel, b, s, k)
        finish(name, "%d x %d, S=%d, %d active, K=%d" % (n, c, s, n_active,
                                                         k),
               {"n": n, "active": n_active, "C": c, "B": b, "K": k, "S": s},
               max_err,
               lambda: slot_call(kernels, xb, slot, v, sel, b, s, k),
               lambda: slot_plain(xb, slot, v, sel, b, s, k), library,
               kernels.slot_hist_bytes(n, n_active, c, b, k, s),
               n_active * c * k)
        del slot, v, sel, got, want64, absum64, library

    # ---- hist_part.cu: S = 16, every row-holding tile active -----------
    inputs, tile = part_inputs(dev, s, 1.0, stored=stored)
    xb_fm, sel, vals3, tile_slot, first = inputs
    got = part_call(kernels, inputs, b, s, tile)
    want64 = hist.hist_part_tiles_plain(xb_fm, sel.double(), vals3.double(),
                                        tile_slot, first, b, s, tile)
    absum64 = hist.hist_part_tiles_plain(xb_fm, sel.double(),
                                         vals3.double().abs(), tile_slot,
                                         first, b, s, tile)
    max_err = held_to_f64(got, want64, absum64, "hist_part.cu")
    library, active_tiles, n_act = part_library(inputs, b, s, tile)
    n_tiles = int(tile_slot.numel())
    plan = kernels.part_hist_launch_plan(n_tiles, c, b,
                                         kernels._sm_count(dev))
    finish("hist_part", "Np %d (%d tiles, %d active), S=%d, %d feature "
           "tiles of %d" % (xb_fm.shape[1], n_tiles, active_tiles, s,
                            plan.tiles, plan.feature_tile),
           {"Np": int(xb_fm.shape[1]), "tiles": n_tiles,
            "active_tiles": active_tiles, "C": c, "B": b, "S": s,
            "feature_tiles": plan.tiles, "feature_tile": plan.feature_tile},
           max_err, lambda: part_call(kernels, inputs, b, s, tile),
           lambda: part_plain(inputs, b, s, tile), library,
           kernels.part_hist_bytes(active_tiles, n_tiles, tile, c, b, s),
           n_act * c * 6)
    del inputs, got, want64, absum64, library, xb
    return out


# the kernel wrappers, each with its launch count
COUNTED = (kernels.build_histogram_cuda, kernels.build_histogram_leaf_cuda,
           kernels.build_histogram_f64_cuda,
           kernels.build_histogram_leaf_f64_cuda,
           kernels.build_histogram_words_cuda,
           kernels.build_histogram_slots_words_cuda,
           kernels.build_histogram_slots_cuda,
           kernels.build_histogram_slots6_cuda,
           kernels.build_histogram_part_tiles_cuda,
           kernels.partition_tiles_cuda)
# the kernels each main path must launch
PATH_KERNELS = {
    "exact": ("build_histogram_cuda",),
    "frontier": ("build_histogram_cuda", "build_histogram_slots_cuda"),
    "batched": ("build_histogram_cuda", "build_histogram_slots6_cuda"),
    "batched_part": ("build_histogram_cuda",
                     "build_histogram_part_tiles_cuda"),
}
# the wrapper launched once per wave or step of a wave path
WAVE_KERNEL = {"frontier": "build_histogram_slots_cuda",
               "batched": "build_histogram_slots6_cuda",
               "batched_part": "build_histogram_part_tiles_cuda"}


def reset_counts() -> None:
    for wrapper in COUNTED:
        wrapper.launches = 0


def read_counts():
    return {w.__name__: w.launches for w in COUNTED}


def train_counted(params, ds, rounds: int = NUM_ITERS, **kwargs):
    """Train ``rounds`` iterations with the launch counts set to 0 just
    before and read just after; returns (booster, train seconds, launches,
    the partitioned grower's steps, each of which calls hist_part_tiles)."""
    steps = []
    dispatch = grow_batched_part.hist_part_tiles

    def counted(*args):
        steps.append(1)
        return dispatch(*args)
    grow_batched_part.hist_part_tiles = counted
    try:
        reset_counts()
        t0 = time.perf_counter()
        bst = lgb.train(params, ds, num_boost_round=rounds, **kwargs)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    finally:
        grow_batched_part.hist_part_tiles = dispatch
    return bst, train_s, read_counts(), len(steps)


def check_path_launches(label: str, growth: str, bst, launches,
                        steps: int) -> None:
    """Raises unless the path launched each of its kernels, a root pass a
    tree and (batched_part) one part pass a step."""
    for name in PATH_KERNELS[growth]:
        if launches[name] <= 0:
            raise AssertionError("path %s never launched %s" % (label, name))
    if launches["build_histogram_cuda"] < len(bst.models):
        raise AssertionError("path %s built fewer root histograms than "
                             "trees" % label)
    if launches["build_histogram_f64_cuda"]:
        raise AssertionError("f32 path %s launched the f64 kernel" % label)
    if growth == "batched_part" and launches[WAVE_KERNEL[growth]] != steps:
        raise AssertionError("path %s launched the part kernel %d times in "
                             "%d steps" % (label,
                                           launches[WAVE_KERNEL[growth]],
                                           steps))


def drive_path(growth: str, ds, x, y, keep: Optional[dict] = None):
    """Phase 4: one growth mode's main path at full width, with the launch
    counts set to 0 just before and read just after; the booster goes in
    ``keep`` under its growth mode where given (path 4zs predicts with
    it)."""
    params = dict(PARAMS, **GROWTH_PARAMS[growth])
    bst, train_s, launches, steps = train_counted(params, ds)
    t0 = time.perf_counter()
    prob = bst.predict(x)
    predict_s = time.perf_counter() - t0
    train_auc = auc(prob, y)
    leaves = [t.num_leaves_actual for t in bst.models]
    # one slot-kernel launch per frontier wave or batched step
    waves = launches[WAVE_KERNEL[growth]] if growth in WAVE_KERNEL else None
    log("path %s: train %.2f s (%d iterations, %.3f s per iteration), "
        "predict %.3f s, trees %s leaves%s" % (
            growth, train_s, len(bst.models), train_s / len(bst.models),
            predict_s, leaves,
            ", %.1f waves per tree" % (waves / len(bst.models))
            if waves is not None else ""))
    log("path %s: train AUC %.6f (JAX package %.6f), launches %s"
        % (growth, train_auc, JAX_REFERENCE_AUC[growth], launches))
    check_path_launches(growth, growth, bst, launches, steps)
    if prob.shape != (len(x),) or not np.isfinite(prob).all():
        raise AssertionError("predictions are not finite [n] probabilities")
    if len(bst.models) != NUM_ITERS:
        raise AssertionError("expected %d trees, got %d"
                             % (NUM_ITERS, len(bst.models)))
    if abs(train_auc - JAX_REFERENCE_AUC[growth]) > AUC_TOLERANCE:
        raise AssertionError("path %s: train AUC %.6f is more than %g from "
                             "the JAX package's %.6f"
                             % (growth, train_auc, AUC_TOLERANCE,
                                JAX_REFERENCE_AUC[growth]))
    out = {"train_s": train_s, "s_per_iter": train_s / len(bst.models),
           "predict_s": predict_s, "auc": train_auc, "leaves": leaves,
           "waves_per_tree": (waves / len(bst.models)
                              if waves is not None else None),
           "launches": launches}
    out.update(iteration_counts(growth, bst))
    if keep is not None:
        keep[growth] = bst
    return out


def iteration_counts(label: str, bst, fobj=None) -> dict:
    """One more iteration of ``bst`` under torch.profiler (after the
    path's checks: it adds a tree): its CUDA kernel launches and its
    host-device synchronisations, as scripts/profile_main_path.py counts
    them, here from the profiler's raw events: its summary
    (``key_averages``) gives the same counts but took 13.8-14.0 s for an
    exact iteration's events on an H100, the raw count 0.4 s
    (scripts/constraint_tie_repeats.py --profile-cost)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # CUDA activity alone records the runtime's launch and sync calls: the
    # same counts as with CPU activity, at a third of the time
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        bst.update(fobj=fobj)
        torch.cuda.synchronize()
    events = collections.Counter(
        e.name() for e in prof.profiler.kineto_results.events())
    seconds = time.perf_counter() - t0

    def count(*names):
        return sum(events[name] for name in names)
    own = collections.Counter()
    for e in prof.profiler.kineto_results.events():
        match = OWN_KERNEL_KEY.match(e.name())
        if match:
            own[match.group(1)] += e.duration_ns() / 1e6
    out = {"launches_per_iter": count("cudaLaunchKernel", "cuLaunchKernel",
                                      "cudaLaunchKernelExC"),
           "syncs_per_iter": count("cudaStreamSynchronize",
                                   "cudaDeviceSynchronize"),
           "own_kernel_ms_per_iter": dict(own)}
    log("path %s: one more iteration under the profiler: %d kernel "
        "launches, %d synchronisations, the port's kernels' device ms %s "
        "(%.1f s, the count included)"
        % (label, out["launches_per_iter"], out["syncs_per_iter"],
           {k: round(v, 4) for k, v in own.items()}, seconds))
    return out


def drive_f64_path(label: str, ds, x, y, dense: dict) -> dict:
    """Phase 4zn-4zp: exact growth with float64 histograms (F64_PATHS) at
    full width on a data set phase 4 already binned (``y`` its labels,
    None for the ranking data), with the launch counts set to 0 just
    before and read just after: every histogram pass through the f64
    kernel and none through the f32 one, the train metric held to the
    JAX package's f64 constant, s/iter, launches and syncs beside
    ``dense``, the f32 path of the same data and growth."""
    extra, data, beside = F64_PATHS[label]
    params = dict(PARAMS, **GROWTH_PARAMS["exact"], **extra)
    if data == "ranking":
        params.update(RANKING_PARAMS)
    bst, train_s, launches, _ = train_counted(params, ds)
    if bst._impl.grow_params.hist_dtype != "f64":
        raise AssertionError("path %s did not grow in float64" % label)
    f64_passes = launches["build_histogram_f64_cuda"]
    others = {k: v for k, v in launches.items()
              if v and k != "build_histogram_f64_cuda"}
    splits = sum(t.num_leaves_actual - 1 for t in bst.models)
    if f64_passes != splits + len(bst.models) or others:
        raise AssertionError("path %s: %d f64 histogram passes for %d "
                             "trees of %d splits, other kernels %s"
                             % (label, f64_passes, len(bst.models), splits,
                                others))
    if len(bst.models) != NUM_ITERS:
        raise AssertionError("expected %d trees, got %d"
                             % (NUM_ITERS, len(bst.models)))
    want = JAX_F64_METRIC[label]
    if data == "ranking":
        got = {m: v for _, m, v, _ in bst.eval_train()}
        off = {m: abs(got[m] - w) / w for m, w in want.items()}
        ok = max(off.values()) <= F64_NDCG_REL_TOL
    else:
        prob = bst.predict(x)
        if prob.shape != (len(x),) or not np.isfinite(prob).all():
            raise AssertionError("predictions are not finite [n] "
                                 "probabilities")
        got = {"auc": auc(prob, y)}
        off = {"auc": abs(got["auc"] - want["auc"])}
        ok = off["auc"] <= F64_AUC_TOL
    log("path %s (%s, %s data): train %.2f s (%.3f s per iteration), "
        "leaves %s, train %s against the JAX package's %s (off by %s), "
        "launches %s" % (label, extra, data, train_s,
                         train_s / len(bst.models),
                         [t.num_leaves_actual for t in bst.models],
                         {m: round(v, 10) for m, v in got.items()}, want,
                         {m: "%.3g" % v for m, v in off.items()},
                         {k: v for k, v in launches.items() if v}))
    if not ok:
        raise AssertionError("path %s: train metrics %s are off the JAX "
                             "package's %s by %s (limits: AUC %g absolute, "
                             "ndcg %g relative)" % (label, got, want, off,
                                                   F64_AUC_TOL,
                                                   F64_NDCG_REL_TOL))
    out = {"growth": "exact", "data": data, "params": extra,
           "train_s": train_s, "s_per_iter": train_s / len(bst.models),
           "train": got, "jax": want, "off": off,
           "leaves": [t.num_leaves_actual for t in bst.models],
           "launches": launches}
    out.update(iteration_counts(label, bst))
    log("path %s against %s (the same data and growth in f32): %.3f against "
        "%.3f s per iteration (%.2fx), %d against %d launches and %d "
        "against %d syncs an iteration" % (
            label, beside, out["s_per_iter"], dense["s_per_iter"],
            out["s_per_iter"] / dense["s_per_iter"],
            out["launches_per_iter"], dense["launches_per_iter"],
            out["syncs_per_iter"], dense["syncs_per_iter"]))
    out["beside"] = {"path": beside, "s_per_iter": dense["s_per_iter"],
                     "launches_per_iter": dense["launches_per_iter"],
                     "syncs_per_iter": dense["syncs_per_iter"]}
    return out


BINNED_FIELDS = ("num_data", "num_total_features", "used_features",
                 "col_features", "col_offsets", "col_num_bin", "col_packed")


def same_binned(a, b, what: str) -> None:
    """Raises unless the binned datasets ``a`` and ``b`` hold the same
    stored matrix byte for byte, the same mappers and layout, and the same
    labels, weights, query boundaries and init scores."""
    for name in BINNED_FIELDS:
        if getattr(a, name) != getattr(b, name):
            raise AssertionError("%s: %s differs" % (what, name))
    if json.dumps([m.to_dict() for m in a.bin_mappers]) \
            != json.dumps([m.to_dict() for m in b.bin_mappers]):
        raise AssertionError("%s: the bin mappers differ" % what)
    if a.X_binned.dtype != b.X_binned.dtype \
            or not np.array_equal(a.X_binned, b.X_binned):
        raise AssertionError("%s: the stored matrices differ" % what)
    for name in ("label", "weight", "query_boundaries", "init_score"):
        va, vb = getattr(a.metadata, name), getattr(b.metadata, name)
        if (va is None) != (vb is None) or (
                va is not None and not np.array_equal(va, vb)):
            raise AssertionError("%s: metadata %s differs" % (what, name))


def predict_row_blocks(bst, x, **kwargs) -> np.ndarray:
    """``bst.predict`` of a CSR ``x`` densified a row block at a time, in
    the blocks of ``Booster.predict``'s own sparse path."""
    block = max(256, (1 << 24) // x.shape[1])
    return np.concatenate([bst.predict(x[lo:lo + block].toarray(), **kwargs)
                           for lo in range(0, x.shape[0], block)])


def drive_sparse_path(x, y, dense: dict, keep: dict) -> dict:
    """Phase 4zq: exact growth from the sparse CSR ``x`` (``sparse_data``)
    at full width, binned without densifying it, with the launch counts set
    to 0 just before training and read just after: EFB packs every one-hot
    column into a bundle, the train AUC (of the training scores) is held
    to the JAX package's, and on the CSR's first SPARSE_PREDICT_ROWS rows
    predict equals predict on them densified block by block (the row
    blocks' assembly) and the training scores, and pred_leaf equals the
    leaves the binned training replay gives (``replay_leaves_binned`` on
    the stored, bundled columns: raw thresholds against bin thresholds).
    The booster goes in ``keep`` (path 4zs)."""
    t0 = time.perf_counter()
    ds = lgb.Dataset(x, label=y, params=PARAMS).construct()
    binning_s = time.perf_counter() - t0
    binned = ds._binned
    onehot = SPARSE_BLOCKS * SPARSE_WIDTH
    column_of = {j: c for c, cols in enumerate(binned.col_features)
                 for j in cols if len(cols) > 1}
    spans = [len({column_of.get(j) for j in range(b * SPARSE_WIDTH,
                                                   (b + 1) * SPARSE_WIDTH)})
             for b in range(SPARSE_BLOCKS)]
    log("path 4zq: binning %.2f s for a CSR of %d x %d with %d stored "
        "values (%d MB): %d stored columns (B=%d), %d of the %d one-hot "
        "columns in EFB bundles, each block in %s stored columns; 4a's 1M x "
        "28 binned in %.2f s"
        % (binning_s, *x.shape, x.nnz,
           (x.data.nbytes + x.indices.nbytes + x.indptr.nbytes) >> 20,
           binned.num_columns, binned.max_col_bins(),
           sum(j in column_of for j in range(onehot)), onehot, spans,
           dense["binning_s"]))
    if any(j not in column_of for j in range(onehot)):
        raise AssertionError("path 4zq: EFB left one-hot columns unbundled")
    params = dict(PARAMS, **GROWTH_PARAMS["exact"])
    bst, train_s, launches, steps = train_counted(params, ds)
    check_path_launches("4zq", "exact", bst, launches, steps)
    trees = len(bst.models)
    if trees != NUM_ITERS:
        raise AssertionError("path 4zq: expected %d trees, got %d"
                             % (NUM_ITERS, trees))
    # the training scores are predict's (4a-4d hold that on the dense data),
    # and a full predict of 1M rows in 60 row blocks takes ~30 s each way
    train_auc = auc(bst._impl.scores_of(0), y)
    rows = x[:SPARSE_PREDICT_ROWS]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    raw = bst.predict(rows, raw_score=True)
    sparse_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    raw_dense = predict_row_blocks(bst, rows, raw_score=True)
    dense_s = time.perf_counter() - t0
    if not np.array_equal(raw, raw_dense):
        raise AssertionError("path 4zq: predict on the CSR differs from the "
                             "densified rows' by %.3g"
                             % float(np.abs(raw - raw_dense).max()))
    scores_diff = float(np.abs(raw - bst._impl.scores_of(0)[:len(raw)])
                        .max())
    if scores_diff > VALID_SCORE_TOL:
        raise AssertionError("path 4zq: predict on the CSR is %.3g from the "
                             "training scores" % scores_diff)
    t0 = time.perf_counter()
    ids = bst.predict(rows, pred_leaf=True)
    leaf_s = time.perf_counter() - t0
    impl = bst._impl
    xb = impl.xb[:len(raw)]
    leaf_misses = sum(int((tree_mod.replay_leaves_binned(
        impl._binned_tree(ht), xb).cpu().numpy() != ids[:, i]).sum())
        for i, ht in enumerate(bst.models))
    if leaf_misses:
        raise AssertionError("path 4zq: pred_leaf on the CSR is %d leaf ids "
                             "off the binned training replay" % leaf_misses)
    splits = splits_on_layout(bst.models, binned)
    out = {"binning_s": binning_s, "C": binned.num_columns,
           "B": binned.max_col_bins(), "nnz": int(x.nnz),
           "train_s": train_s, "s_per_iter": train_s / trees,
           "predict_rows": len(raw), "predict_csr_s": sparse_s,
           "predict_dense_blocks_s": dense_s,
           "predict_scores_max_diff": scores_diff,
           "pred_leaf_csr_s": leaf_s,
           "pred_leaf_replay_misses": leaf_misses,
           "auc": train_auc, "jax_auc": JAX_SPARSE_AUC,
           "leaves": [t.num_leaves_actual for t in bst.models],
           "splits_on": splits, "launches": launches}
    log("path 4zq: train %.2f s (%.3f s per iteration, 4a %.3f), trees %s "
        "leaves; predict %d rows from the CSR %.2f s, densified block by "
        "block %.2f s, raw scores equal, %.3g from the training scores; "
        "pred_leaf from the CSR %.2f s, %d leaf ids off the binned replay; "
        "train AUC %.6f (JAX package %.6f), %d splits, %d on bundled "
        "features, launches %s"
        % (train_s, out["s_per_iter"], dense["s_per_iter"], out["leaves"],
           len(raw), sparse_s, dense_s, scores_diff, leaf_s, leaf_misses,
           train_auc,
           JAX_SPARSE_AUC,
           splits["splits"], splits["bundled"], launches))
    if abs(train_auc - JAX_SPARSE_AUC) > AUC_TOLERANCE:
        raise AssertionError("path 4zq: train AUC %.6f is more than %g from "
                             "the JAX package's %.6f"
                             % (train_auc, AUC_TOLERANCE, JAX_SPARSE_AUC))
    if splits["bundled"] < 1:
        raise AssertionError("path 4zq: no split on a bundled feature")
    out.update(iteration_counts("4zq", bst))
    log("path 4zq against 4a: %d against %d launches, %d against %d syncs "
        "an iteration; the port's kernels' device ms an iteration %s "
        "against %s" % (out["launches_per_iter"], dense["launches_per_iter"],
                        out["syncs_per_iter"], dense["syncs_per_iter"],
                        out["own_kernel_ms_per_iter"],
                        dense["own_kernel_ms_per_iter"]))
    keep["4zq"] = bst
    return out


def write_libsvm(path: str, x, y) -> None:
    """A CSR ``x`` with labels ``y`` as a libsvm file, values "%.17g"."""
    with open(path, "w") as fh:
        for i in range(x.shape[0]):
            lo, hi = x.indptr[i], x.indptr[i + 1]
            fh.write(" ".join(["%.17g" % y[i]] + [
                "%d:%.17g" % kv for kv in zip(x.indices[lo:hi].tolist(),
                                               x.data[lo:hi].tolist())])
                     + "\n")


def drive_file_paths(x, y, ds, x_sparse, y_sparse, tmp: str) -> dict:
    """Phase 4zr: files and the binary cache, with the launch counts set to
    0 just before and read just after. The first FILE_ROWS rows of the
    dense data (``ds`` their Dataset, 4a's) as a CSV file and LIBSVM_ROWS
    rows of the sparse data as a libsvm file bin byte for byte as the same
    rows in memory do; the binary cache of ``ds`` loads byte for byte, and
    DP_ROUNDS rounds under gpu_use_dp (f64 kernel runs repeat themselves)
    grow the same trees from it as from ``ds``."""
    reset_counts()
    out = {}
    csv = os.path.join(tmp, "dense.csv")
    t0 = time.perf_counter()
    np.savetxt(csv, np.column_stack([y[:FILE_ROWS], x[:FILE_ROWS]]),
               fmt="%.17g", delimiter=",", comments="", header=",".join(
                   ["label"] + ["f%d" % j for j in range(x.shape[1])]))
    out["csv_write_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    from_csv = lgb.Dataset(csv, params=dict(PARAMS, header=True)).construct()
    out["csv_parse_bin_s"] = time.perf_counter() - t0
    same_binned(from_csv._binned, lgb.Dataset(
        x[:FILE_ROWS], label=y[:FILE_ROWS], params=PARAMS).construct()._binned,
        "path 4zr, the CSV file")
    svm = os.path.join(tmp, "sparse.svm")
    rows = x_sparse[:LIBSVM_ROWS]
    t0 = time.perf_counter()
    write_libsvm(svm, rows, y_sparse[:LIBSVM_ROWS])
    out["libsvm_write_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    from_svm = lgb.Dataset(svm, params=PARAMS).construct()
    out["libsvm_parse_bin_s"] = time.perf_counter() - t0
    same_binned(from_svm._binned, lgb.Dataset(
        rows, label=y_sparse[:LIBSVM_ROWS], params=PARAMS)
        .construct()._binned, "path 4zr, the libsvm file")
    cache = os.path.join(tmp, "dense.bin")
    t0 = time.perf_counter()
    ds.save_binary(cache)
    out["save_binary_s"] = time.perf_counter() - t0
    out["cache_bytes"] = os.path.getsize(cache)
    t0 = time.perf_counter()
    loaded = lgb.Dataset(cache).construct()
    out["load_binary_s"] = time.perf_counter() - t0
    same_binned(loaded._binned, ds._binned, "path 4zr, the binary cache")
    params = dict(PARAMS, gpu_use_dp=True, **GROWTH_PARAMS["exact"])
    forests = [lgb.train(params, d, num_boost_round=DP_ROUNDS).models
               for d in (ds, loaded)]
    at = first_difference(*forests)
    if at is not None:
        raise AssertionError("path 4zr: the cache's f64 trees part from the "
                             "in-memory Dataset's at (tree, node) %s" % (at,))
    out["launches"] = read_counts()
    if out["launches"]["build_histogram_f64_cuda"] <= 0:
        raise AssertionError("path 4zr: no f64 histogram pass")
    log("path 4zr: CSV of %d x %d written %.2f s, parsed and binned %.2f s; "
        "libsvm of %d x %d written %.2f s, parsed and binned %.2f s; both "
        "byte for byte the rows in memory; binary cache of %d rows (%d "
        "bytes) saved %.2f s, loaded %.2f s, byte for byte, and %d f64 "
        "rounds from it identical node for node; launches %s"
        % (FILE_ROWS, x.shape[1], out["csv_write_s"],
           out["csv_parse_bin_s"], LIBSVM_ROWS, rows.shape[1],
           out["libsvm_write_s"], out["libsvm_parse_bin_s"], ds.num_data(),
           out["cache_bytes"], out["save_binary_s"], out["load_binary_s"],
           DP_ROUNDS, out["launches"]))
    return out


def early_stop_emulation(models, k: int, leaves: np.ndarray, freq: int,
                         margin: float):
    """Raw scores [N, K] and the rows stopped under the margin early stop,
    on the host from the rows' leaves in ``models`` (K trees an iteration;
    ``pred_leaf``'s class-major layout), the trees' values summed in
    float32 as ``predict`` sums."""
    iters = len(models) // k
    acc = np.zeros((len(leaves), k), np.float32)
    stopped = np.zeros(len(leaves), bool)
    for it in range(iters):
        for c in range(k):
            value = models[it * k + c].leaf_value.astype(np.float32)[
                leaves[:, c * iters + it]]
            acc[:, c] += np.where(stopped, np.float32(0), value)
        if (it + 1) % freq == 0:
            top = np.sort(acc, axis=1)
            reached = (top[:, -1] - top[:, -2] if k > 1
                       else 2 * np.abs(acc[:, 0])) >= margin
            stopped |= reached
    return acc, stopped


def drive_prediction_extras(label: str, bst, x, leaves: bool = False,
                            early_stop: bool = False,
                            plain_rows: int = CONTRIB_PLAIN_ROWS) -> dict:
    """Phase 4zs on the model of path ``label`` and its training rows ``x``
    (a CSR for 4zq). With ``leaves``: pred_leaf on every row, on the card,
    equal to the leaves the training replay gives (``replay_leaves_binned``
    on the stored matrix), the leaf values there summing to the raw
    scores. With ``early_stop``: pred_early_stop at margin 1e30 is predict
    on every row, and at margin 10 (freq 5) and at the median margin of
    the first iteration (freq 1) it is the host emulation of the rule on
    EARLY_STOP_ROWS rows. Always: pred_contrib on CONTRIB_ROWS rows, on
    the card, each class's columns summing to its raw score, and on
    ``plain_rows`` of them the plain recursion's values."""
    impl = bst._impl
    dev = impl.device
    k = impl.num_tree_per_iteration
    # predict's trees: those of the best iteration, which phase 4's
    # profiled iteration is past
    iters = (bst.best_iteration if bst.best_iteration > 0
             else len(impl.models) // k)
    models = impl.models[:iters * k]
    out = {"trees": len(models)}
    if leaves:
        xt = torch.as_tensor(x, dtype=torch.float64, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = tree_mod.predict_forest_leaves(
            tree_mod.stack_predict_trees(models, dev), xt)
        torch.cuda.synchronize()
        out["pred_leaf_s"] = time.perf_counter() - t0
        if ids.device.type != "cuda":
            raise AssertionError("path 4zs: pred_leaf ran on %s" % ids.device)
        api = bst.predict(x, pred_leaf=True)
        if not np.array_equal(api, ids.cpu().numpy()):
            raise AssertionError("path 4zs (%s): Booster.predict's pred_leaf "
                                 "differs from the device forest's" % label)
        misses = sum(int((tree_mod.replay_leaves_binned(
            impl._binned_tree(ht), impl.xb).to(torch.int32)
            != ids[:, i]).sum()) for i, ht in enumerate(models))
        total = torch.zeros(len(x), dtype=torch.float32, device=dev)
        for i, ht in enumerate(models):
            total += torch.as_tensor(ht.leaf_value.astype(np.float32),
                                     device=dev)[ids[:, i].long()]
        out["leaf_raw_max_diff"] = float(np.abs(
            total.cpu().numpy() - bst.predict(x, raw_score=True)).max())
        out["replay_misses"] = misses
        log("path 4zs (%s): pred_leaf of %d rows in %d trees on %s %.3f s; "
            "%d leaf ids off the training replay; their leaf values sum to "
            "the raw scores within %.3g" % (
                label, len(x), len(models), ids.device,
                out["pred_leaf_s"], misses, out["leaf_raw_max_diff"]))
        if misses or out["leaf_raw_max_diff"] > EXTRAS_RAW_TOL:
            raise AssertionError("path 4zs (%s): pred_leaf is not the "
                                 "training replay" % label)
        del xt, ids, total
    if early_stop:
        raw = bst.predict(x, raw_score=True)
        t0 = time.perf_counter()
        never = bst.predict(x, raw_score=True, pred_early_stop=True,
                            pred_early_stop_freq=5,
                            pred_early_stop_margin=1e30)
        out["early_stop_s"] = time.perf_counter() - t0
        out["early_stop_1e30_max_diff"] = float(np.abs(never - raw).max())
        rows = x[:EARLY_STOP_ROWS]
        ids = bst.predict(rows, pred_leaf=True)
        first = np.zeros((len(rows), k), np.float32)
        for c in range(k):
            first[:, c] = models[c].leaf_value.astype(np.float32)[
                ids[:, c * iters]]
        top = np.sort(first, axis=1)
        median = float(np.median(top[:, -1] - top[:, -2] if k > 1
                                 else 2 * np.abs(first[:, 0])))
        out["rule"] = {}
        for freq, margin in ((5, 10.0), (1, median)):
            want, stopped = early_stop_emulation(models, k, ids, freq,
                                                 margin)
            got = bst.predict(rows, raw_score=True, pred_early_stop=True,
                              pred_early_stop_freq=freq,
                              pred_early_stop_margin=margin)
            diff = float(np.abs(got.reshape(len(rows), k) - want).max())
            out["rule"]["freq %d, margin %.6g" % (freq, margin)] = {
                "stopped": int(stopped.sum()), "max_diff": diff}
            if diff > EXTRAS_RAW_TOL:
                raise AssertionError("path 4zs (%s): early stop at freq %d, "
                                     "margin %g is %.3g from the emulation"
                                     % (label, freq, margin, diff))
        log("path 4zs (%s): pred_early_stop at margin 1e30 on %d rows %.3f "
            "s, %.3g from predict; the rule on %d rows against the host "
            "emulation %s" % (label, len(x), out["early_stop_s"],
                              out["early_stop_1e30_max_diff"], len(rows),
                              out["rule"]))
        if out["early_stop_1e30_max_diff"] > EXTRAS_RAW_TOL:
            raise AssertionError("path 4zs (%s): early stop at margin 1e30 "
                                 "is not predict" % label)
    rows = x[:CONTRIB_ROWS]
    if hasattr(rows, "toarray"):
        rows = rows.toarray()
    raw = bst.predict(rows, raw_score=True).reshape(len(rows), k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    contrib = bst.predict(rows, pred_contrib=True).reshape(len(rows), k, -1)
    out["contrib_s"] = time.perf_counter() - t0
    scale = np.maximum(1.0, np.abs(raw))
    out["contrib_sum_max_rel"] = float(
        (np.abs(contrib.sum(axis=2) - raw) / scale).max())
    head = rows[:plain_rows]
    on_card = shap.contrib_tensor(impl, torch.as_tensor(
        head, dtype=torch.float64, device=dev), iters)
    if on_card.device.type != "cuda":
        raise AssertionError("path 4zs: pred_contrib ran on %s"
                             % on_card.device)
    t0 = time.perf_counter()
    plain = shap.predict_contrib_plain(impl, head, iters).reshape(
        len(head), k, -1)
    out["contrib_plain_s"] = time.perf_counter() - t0
    absum = np.abs(plain).sum(axis=2)
    out["contrib_plain_max_rel"] = float(max(
        (np.abs(ours - plain).max(axis=2) / absum).max()
        for ours in (contrib[:len(head)], on_card.cpu().numpy())))
    # TreeSHAP's unique depth: the two orders of summation part further on
    # deeper merged paths (scripts/shap_depth_probe.py)
    out["longest_merged_path"] = max(
        shap.tree_paths(ht, torch.device("cpu")).max_depth
        for ht in models if ht.num_leaves_actual > 1)
    log("path 4zs (%s): pred_contrib of %d rows x %d columns on %s %.3f s; "
        "classes sum to the raw scores within %.3g of max(1, |raw|); the "
        "plain recursion on %d rows (%.2f s) within %.3g of a row's sum of "
        "|contrib|; longest merged path %d"
        % (label, len(rows), contrib.shape[2] * k, on_card.device,
           out["contrib_s"], out["contrib_sum_max_rel"], len(head),
           out["contrib_plain_s"], out["contrib_plain_max_rel"],
           out["longest_merged_path"]))
    if out["contrib_sum_max_rel"] > EXTRAS_RAW_TOL:
        raise AssertionError("path 4zs (%s): contributions do not sum to the "
                             "raw scores" % label)
    if out["contrib_plain_max_rel"] > CONTRIB_PLAIN_REL:
        raise AssertionError("path 4zs (%s): contributions are %.3g from "
                             "the plain recursion's"
                             % (label, out["contrib_plain_max_rel"]))
    return out


def require_histogram(label: str, launches: dict,
                      name: str = "build_histogram_cuda") -> None:
    if launches[name] <= 0:
        raise AssertionError("path %s never launched %s" % (label, name))


def leaf_values_of(node, out: dict) -> None:
    """Each leaf's value of a ``dump_model`` tree, by leaf index."""
    if "leaf_index" in node:
        out[node["leaf_index"]] = node["leaf_value"]
        return
    leaf_values_of(node["left_child"], out)
    leaf_values_of(node["right_child"], out)


def check_booster_methods(bst, num_features: int) -> dict:
    """Path 4zt on a fitted estimator's booster: ``dump_model``'s leaf
    values are the trees', ``get_leaf_output`` reads LEAF_SAMPLE sampled
    leaves, and ``get_split_value_histogram`` counts every numerical split
    on each feature."""
    t0 = time.perf_counter()
    dump = bst.dump_model(num_iteration=-1)
    if len(dump["tree_info"]) != len(bst.models):
        raise AssertionError("path 4zt: dump_model has %d trees, the "
                             "booster %d" % (len(dump["tree_info"]),
                                             len(bst.models)))
    for info, ht in zip(dump["tree_info"], bst.models):
        leaves = {}
        leaf_values_of(info["tree_structure"], leaves)
        want = {i: float(v) for i, v in
                enumerate(ht.leaf_value[:ht.num_leaves_actual])}
        if leaves != want:
            raise AssertionError("path 4zt: dump_model's leaf values of "
                                 "tree %d are not the tree's"
                                 % info["tree_index"])
    r = np.random.RandomState(0)
    for _ in range(LEAF_SAMPLE):
        t = int(r.randint(len(bst.models)))
        leaf = int(r.randint(bst.models[t].num_leaves_actual))
        if bst.get_leaf_output(t, leaf) != float(
                bst.models[t].leaf_value[leaf]):
            raise AssertionError("path 4zt: get_leaf_output(%d, %d) is "
                                 "not the tree's leaf" % (t, leaf))
    counts = []
    for f in range(num_features):
        want = sum(int(((ht.split_feature[:ht.num_leaves_actual - 1] == f)
                        & ~ht.is_categorical[:ht.num_leaves_actual - 1])
                       .sum()) for ht in bst.models)
        got = int(bst.get_split_value_histogram(f)[0].sum())
        if got != want:
            raise AssertionError("path 4zt: get_split_value_histogram(%d) "
                                 "counts %d splits, the trees have %d"
                                 % (f, got, want))
        counts.append(got)
    return {"splits_by_feature": counts,
            "methods_s": time.perf_counter() - t0}


def drive_sklearn_path(x, y, xv, yv) -> dict:
    """Phase 4zt: the estimators on 4a's rows (``LGBMClassifier``) and on
    4e's rows and target (``LGBMRegressor``), on the CUDA default, with
    the launch counts set to 0 just before and read just after."""
    labels = np.where(y > 0, "pos", "neg")
    reset_counts()
    t0 = time.perf_counter()
    clf = lgb.LGBMClassifier(num_leaves=255, max_bin=255,
                             n_estimators=SKLEARN_TREES)
    clf.fit(x, labels, eval_set=[(xv, np.where(yv > 0, "pos", "neg"))],
            eval_metric="auc", early_stopping_rounds=EARLY_STOPPING_ROUNDS,
            verbose=False)
    torch.cuda.synchronize()
    out = {"classifier_fit_s": time.perf_counter() - t0}
    prob = clf.predict_proba(x, num_iteration=SKLEARN_TREES)[:, 1]
    out["auc"] = auc(prob, y)
    valid_auc = clf.evals_result_["valid_0"]["auc"]
    out.update(valid_auc=valid_auc, best_iteration=clf.best_iteration_,
               classes=[str(c) for c in clf.classes_])
    log("path 4zt: LGBMClassifier fit %.2f s (%d rows, string labels, a "
        "valid set of %d); train AUC %.6f (JAX package %.6f), valid AUC %s,"
        " best iteration %d" % (out["classifier_fit_s"], len(x), len(xv),
                                out["auc"], JAX_REFERENCE_AUC["exact"],
                                valid_auc, clf.best_iteration_))
    if abs(out["auc"] - JAX_REFERENCE_AUC["exact"]) > AUC_TOLERANCE:
        raise AssertionError("path 4zt: train AUC %.6f is more than %g from "
                             "the JAX package's %.6f" % (
                                 out["auc"], AUC_TOLERANCE,
                                 JAX_REFERENCE_AUC["exact"]))
    if len(valid_auc) != SKLEARN_TREES or clf.best_iteration_ <= 0:
        raise AssertionError("path 4zt: %d valid AUCs, best iteration %s"
                             % (len(valid_auc), clf.best_iteration_))
    if clf.booster_.device.type != "cuda":
        raise AssertionError("path 4zt: the estimator trained on %s"
                             % clf.booster_.device)
    rows = xv[:PICKLE_ROWS]
    pred = clf.predict(rows)
    want = np.where(clf.predict_proba(rows)[:, 1] > 0.5, "pos", "neg")
    if not np.array_equal(pred, want):
        raise AssertionError("path 4zt: predict does not give the string "
                             "labels of predict_proba")
    out.update(check_booster_methods(clf.booster_, x.shape[1]))
    t0 = time.perf_counter()
    blob = pickle.dumps(clf)
    loaded = pickle.loads(blob)
    out.update(pickle_bytes=len(blob),
               pickle_s=time.perf_counter() - t0)
    if loaded.booster_.device.type != "cuda" or not np.array_equal(
            loaded.predict_proba(rows), clf.predict_proba(rows)):
        raise AssertionError("path 4zt: the unpickled estimator predicts "
                             "otherwise (or off the card)")
    # the regressor: 4e's parameters, rows, target and validation set
    _, t = regression_data(len(x))
    xv_reg, tv = regression_data(VALID_ROWS, seed=1)

    def l2_np(y_true, y_pred):
        return "l2_np", float(np.mean((y_pred - y_true) ** 2)), False
    t0 = time.perf_counter()
    reg = lgb.LGBMRegressor(num_leaves=255, max_bin=255,
                            n_estimators=SKLEARN_TREES)
    reg.fit(x, t, eval_set=[(xv_reg, tv)], eval_metric=l2_np,
            verbose=False)
    torch.cuda.synchronize()
    out["regressor_fit_s"] = time.perf_counter() - t0
    out["train_l2"] = float(np.mean((reg.predict(x) - t) ** 2))
    out["valid_l2_np"] = reg.evals_result_["valid_0"]["l2_np"]
    ref = JAX_REFERENCE_METRIC["4e"]
    log("path 4zt: LGBMRegressor fit %.2f s; train l2 %.9g (JAX package "
        "%.9g), callable valid l2 %s" % (out["regressor_fit_s"],
                                         out["train_l2"], ref["train"],
                                         out["valid_l2_np"]))
    if abs(out["train_l2"] / ref["train"] - 1) > METRIC_REL_TOL:
        raise AssertionError("path 4zt: train l2 %.9g is more than %g "
                             "relative from the JAX package's %.9g" % (
                                 out["train_l2"], METRIC_REL_TOL,
                                 ref["train"]))
    rel = np.abs(np.asarray(out["valid_l2_np"]) / ref["valid"] - 1)
    if len(rel) != SKLEARN_TREES or rel.max() > METRIC_REL_TOL:
        raise AssertionError("path 4zt: the callable's valid l2 %s is not "
                             "4e's %s" % (out["valid_l2_np"], ref["valid"]))
    out["launches"] = read_counts()
    require_histogram("4zt", out["launches"])
    log("path 4zt: dump_model, get_leaf_output (%d leaves) and "
        "get_split_value_histogram (%d splits) %.2f s; pickle %d bytes, "
        "%.3f s, predictions equal after it; launches %s" % (
            LEAF_SAMPLE, sum(out["splits_by_feature"]), out["methods_s"],
            out["pickle_bytes"], out["pickle_s"], out["launches"]))
    return out


def drive_cv_path(x, y) -> dict:
    """Phase 4zu: ``lgb.cv`` on 4a's rows from a Dataset with the default
    ``free_raw_data=True``, with the launch counts set to 0 just before
    and read just after."""
    params = dict(PARAMS, metric="auc", **GROWTH_PARAMS["exact"])
    ds = lgb.Dataset(x, label=y, params=PARAMS)
    reset_counts()
    t0 = time.perf_counter()
    res = lgb.cv(params, ds, num_boost_round=CV_ROUNDS, nfold=CV_FOLDS,
                 stratified=True, shuffle=True, seed=0,
                 return_cvbooster=True)
    torch.cuda.synchronize()
    out = {"cv_s": time.perf_counter() - t0, "launches": read_counts()}
    require_histogram("4zu", out["launches"])
    folds = port_engine._make_n_folds(ds, None, CV_FOLDS, params, 0, True,
                                      True)
    tests = np.sort(np.concatenate([te for _, te in folds]))
    if not np.array_equal(tests, np.arange(len(y))):
        raise AssertionError("path 4zu: the test folds do not partition "
                             "the rows")
    share = float(y.mean())
    off = [abs(float(y[te].sum()) - share * len(te)) for _, te in folds]
    for (tr, te), bst in zip(folds, res["cvbooster"].boosters):
        if len(tr) + len(te) != len(y) or bst.num_trees() != CV_ROUNDS \
                or bst._train_set.num_data() != len(tr) \
                or bst.device.type != "cuda":
            raise AssertionError("path 4zu: a fold's booster does not hold "
                                 "its %d training rows on the card"
                                 % len(tr))
    mean, stdv = res["valid auc-mean"], res["valid auc-stdv"]
    gaps = [abs(a - b) for a, b in zip(mean + stdv,
                                       JAX_CV_AUC["mean"] + JAX_CV_AUC["stdv"])]
    out.update(mean=mean, stdv=stdv, max_gap=max(gaps),
               positive_share_off_rows=max(off),
               boosters=len(res["cvbooster"].boosters))
    log("path 4zu: cv of %d folds x %d rounds %.2f s (binning included); "
        "valid auc-mean %s (JAX %s), -stdv %s (JAX %s), largest gap %.3g; "
        "test folds %s rows, positive share off by at most %.2f rows; "
        "launches %s" % (CV_FOLDS, CV_ROUNDS, out["cv_s"], mean,
                         JAX_CV_AUC["mean"], stdv, JAX_CV_AUC["stdv"],
                         out["max_gap"], sorted({len(te) for _, te in folds}),
                         max(off), out["launches"]))
    if max(off) > 1.0:
        raise AssertionError("path 4zu: a test fold's positive share is "
                             "%.2f rows off the whole's" % max(off))
    if len(mean) != CV_ROUNDS or len(stdv) != CV_ROUNDS \
            or out["boosters"] != CV_FOLDS:
        raise AssertionError("path 4zu: %d means, %d stdvs, %d boosters"
                             % (len(mean), len(stdv), out["boosters"]))
    if out["max_gap"] > AUC_TOLERANCE:
        raise AssertionError("path 4zu: cv's AUC is %.3g from the JAX "
                             "package's" % out["max_gap"])
    return out


def run_cli(args, what: str) -> None:
    rc = port_cli.main(list(args))
    if rc != 0:
        raise AssertionError("path 4zv: %s exited %d" % (what, rc))


def tree_text(model_text: str) -> str:
    """A model text without its parameters."""
    return model_text.split("\nparameters:")[0]


def drive_cli_path(x, y, tmp: str) -> dict:
    """Phase 4zv: the command line on 4zr's CSV (``dense.csv`` in ``tmp``),
    with the launch counts set to 0 just before and read just after."""
    csv = os.path.join(tmp, "dense.csv")
    rows_csv = os.path.join(tmp, "predict.csv")
    np.savetxt(rows_csv, np.column_stack([y[:CLI_PREDICT_ROWS],
                                          x[:CLI_PREDICT_ROWS]]),
               fmt="%.17g", delimiter=",", comments="", header=",".join(
                   ["label"] + ["f%d" % j for j in range(x.shape[1])]))
    model = os.path.join(tmp, "cli_model.txt")
    result = os.path.join(tmp, "cli_predict.txt")
    common = ["header=true", "verbosity=-1"]
    train_args = ["task=train", "data=%s" % csv] + [
        "%s=%s" % kv for kv in dict(PARAMS, **GROWTH_PARAMS["exact"]).items()]
    reset_counts()
    out = {}
    t0 = time.perf_counter()
    run_cli(train_args + common + ["num_trees=%d" % CLI_TREES,
                                   "output_model=%s" % model], "task=train")
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_cli(["task=predict", "data=%s" % rows_csv, "input_model=%s" % model,
             "output_result=%s" % result] + common, "task=predict")
    out["predict_s"] = time.perf_counter() - t0
    bst = lgb.Booster(model_file=model)
    if len(bst.models) != CLI_TREES:
        raise AssertionError("path 4zv: the CLI's model has %d trees"
                             % len(bst.models))
    rows = port_parser.parse_file(rows_csv, has_header=True)[0]
    want = bst.predict(rows)
    with open(result) as fh:
        written = fh.read()
    if written.split() != ["%.12g" % v for v in want]:
        raise AssertionError("path 4zv: task=predict's file is not "
                             "Booster.predict to %.12g")
    cpp = os.path.join(tmp, "cli_model.cpp")
    t0 = time.perf_counter()
    run_cli(["task=convert_model", "input_model=%s" % model,
             "convert_model=%s" % cpp], "task=convert_model")
    lib = os.path.join(tmp, "cli_model.so")
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", lib, cpp],
                   check=True, timeout=600)
    out["convert_compile_s"] = time.perf_counter() - t0
    scorer = ctypes.CDLL(lib)
    one = np.zeros(1, np.float64)
    scored = np.empty(CPP_ROWS)
    for i, row in enumerate(np.ascontiguousarray(rows[:CPP_ROWS],
                                                 np.float64)):
        scorer.Predict(row.ctypes.data_as(ctypes.c_void_p),
                       one.ctypes.data_as(ctypes.c_void_p))
        scored[i] = one[0]
    out["cpp_max_rel"] = float(np.max(np.abs(scored - want[:CPP_ROWS])
                                      / np.abs(want[:CPP_ROWS])))
    if out["cpp_max_rel"] > CPP_REL_TOL:
        raise AssertionError("path 4zv: the C++ scorer is %.3g relative "
                             "from predict" % out["cpp_max_rel"])
    # __main__ as a subprocess, on the CUDA default
    sub_result = os.path.join(tmp, "cli_predict_sub.txt")
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "lightgbm_tpu_torch",
                    "task=predict", "data=%s" % rows_csv,
                    "input_model=%s" % model,
                    "output_result=%s" % sub_result] + common,
                   check=True, timeout=600,
                   cwd=os.path.dirname(os.path.abspath(__file__)))
    out["subprocess_s"] = time.perf_counter() - t0
    with open(sub_result) as fh:
        if fh.read() != written:
            raise AssertionError("path 4zv: python -m lightgbm_tpu_torch "
                                 "wrote another prediction file")
    # f64 through the CLI and through lgb.train on the same file
    dp_model = os.path.join(tmp, "cli_model_dp.txt")
    t0 = time.perf_counter()
    run_cli(train_args + common + ["num_trees=%d" % DP_ROUNDS,
                                   "gpu_use_dp=true",
                                   "output_model=%s" % dp_model],
            "task=train gpu_use_dp=true")
    params = dict(PARAMS, gpu_use_dp=True, header=True,
                  **GROWTH_PARAMS["exact"])
    direct = lgb.train(params, lgb.Dataset(csv, params=params),
                       num_boost_round=DP_ROUNDS)
    out["dp_s"] = time.perf_counter() - t0
    with open(dp_model) as fh:
        if tree_text(fh.read()) != tree_text(direct.model_to_string()):
            raise AssertionError("path 4zv: the CLI's f64 model is not "
                                 "lgb.train's on the same file")
    out["launches"] = read_counts()
    require_histogram("4zv", out["launches"])
    require_histogram("4zv", out["launches"], "build_histogram_f64_cuda")
    log("path 4zv: CLI train %.2f s (%d trees, CSV of %d rows parsed), "
        "predict %.2f s (%d rows, equal to Booster.predict to %%.12g), "
        "convert and g++ %.2f s (C++ within %.3g relative on %d rows), "
        "python -m lightgbm_tpu_torch predict %.2f s (the same file), f64 "
        "through the CLI and lgb.train %.2f s (the same trees); launches %s"
        % (out["train_s"], CLI_TREES, FILE_ROWS, out["predict_s"],
           CLI_PREDICT_ROWS, out["convert_compile_s"], out["cpp_max_rel"],
           CPP_ROWS, out["subprocess_s"], out["dp_s"], out["launches"]))
    return out


def drive_reset_path(x, y, xv, yv) -> dict:
    """Phase 4zw: resetting the training data (#20) on the halves of 4a's
    rows, with the launch counts set to 0 just before and read just
    after."""
    half = len(x) // 2
    params = dict(PARAMS, metric="auc", **GROWTH_PARAMS["exact"])
    reset_counts()
    t0 = time.perf_counter()
    first = lgb.Dataset(x[:half], label=y[:half], params=params)
    bst = lgb.Booster(params=params, train_set=first)
    valid = first.create_valid(xv, label=yv)
    bst.add_valid(valid, "valid")
    second = lgb.Dataset(x[half:], label=y[half:], reference=first,
                         params=params).construct()
    out = {"binning_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    for _ in range(RESET_ROUNDS):
        bst.update()
    before = bst.eval_valid()[0][2]
    t1 = time.perf_counter()
    bst.reset_training_data(second)
    torch.cuda.synchronize()
    out["reset_s"] = time.perf_counter() - t1
    after = bst.eval_valid()[0][2]
    replay_gap = float(np.max(np.abs(
        bst._impl.scores_of(0) - bst.predict(x[half:], raw_score=True))))
    for _ in range(RESET_MORE_ROUNDS):
        bst.update()
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t0 - out["reset_s"]
    final = bst.eval_valid()[0][2]
    out.update(valid_before=before, valid_after=after, replay_gap=replay_gap,
               final_auc=final)
    log("path 4zw: %d rounds on %d rows, reset to the other %d in %.2f s "
        "(valid AUC %.9f -> %.9f, new scores %.3g from predict), %d more "
        "rounds: valid AUC %.6f (JAX package %.6f); train %.2f s"
        % (RESET_ROUNDS, half, len(x) - half, out["reset_s"], before, after,
           replay_gap, RESET_MORE_ROUNDS, final, JAX_RESET_AUC,
           out["train_s"]))
    if abs(after - before) > RESET_VALID_TOL:
        raise AssertionError("path 4zw: the reset moved the valid AUC from "
                             "%.9f to %.9f" % (before, after))
    if replay_gap > REPLAY_TOL:
        raise AssertionError("path 4zw: the replayed scores are %.3g from "
                             "predict" % replay_gap)
    if abs(final - JAX_RESET_AUC) > AUC_TOLERANCE:
        raise AssertionError("path 4zw: valid AUC %.6f is more than %g from "
                             "the JAX package's %.6f" % (
                                 final, AUC_TOLERANCE, JAX_RESET_AUC))
    if len(bst.models) != RESET_ROUNDS + RESET_MORE_ROUNDS:
        raise AssertionError("path 4zw: %d trees" % len(bst.models))
    # the two ways to reset, under f64, whose kernel runs repeat
    p64 = dict(params, gpu_use_dp=True)
    t0 = time.perf_counter()
    ways = []
    for way in ("reset_training_data", "update"):
        b = lgb.Booster(params=p64, train_set=first)
        for _ in range(RESET_ROUNDS):
            b.update()
        if way == "update":
            b.update(train_set=second)
        else:
            b.reset_training_data(second)
            b.update()
        ways.append(b)
    torch.cuda.synchronize()
    out["two_ways_s"] = time.perf_counter() - t0
    at = first_difference(ways[0].models, ways[1].models)
    out["two_ways_gap"] = float(np.max(np.abs(
        ways[0]._impl.scores_of(0) - ways[1]._impl.scores_of(0))))
    out["launches"] = read_counts()
    require_histogram("4zw", out["launches"])
    require_histogram("4zw", out["launches"], "build_histogram_f64_cuda")
    log("path 4zw: f64, reset_training_data against update(train_set=...) "
        "%.2f s: trees %s, scores %.3g apart; launches %s"
        % (out["two_ways_s"], "identical" if at is None else
           "part at %s" % (at,), out["two_ways_gap"], out["launches"]))
    if at is not None or out["two_ways_gap"] > REPLAY_TOL:
        raise AssertionError("path 4zw: update(train_set=...) does not "
                             "reach reset_training_data's model")
    return out


# path 4zx, the serving path (Queue 1 #10): the models it serves (a binary
# frontier model of SERVE_ROUNDS iterations on 4a's data, 4m's categorical
# booster, 4r's 5-class booster and 4m's model text reloaded), the request
# sizes (the last split across buckets), the rows each model's references
# are predicted on (seed 1), the threads of the queue's callers, the
# cascades' first stages (binary, multiclass) and the quantized leaves'
# limit relative to the largest |score|
SERVE_ROUNDS = 100
SERVE_SIZES = (1, 16, 17, 1_000, 4_096, 10_000)
SERVE_ROWS = 10_000
SERVE_THREADS = 8
SERVE_CASCADE = {"binary": 10, "multiclass": 2}
SERVE_QUANT_REL = 1e-4
SERVE_LATENCY_REPS = 20
HTTP_LATENCY_SIZES = (1, 16, 1_000, 4_096)


def require_equal(got, want, what: str) -> None:
    """Raise unless ``got`` is ``want`` bit for bit (shape and values)."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.array_equal(got, want):
        diff = (float(np.max(np.abs(got - want)))
                if got.shape == want.shape else float("nan"))
        raise AssertionError("%s: not predict's output (shapes %s, %s; max "
                             "|diff| %g)" % (what, got.shape, want.shape,
                                             diff))


def serve_references(bst, rows, cascade_trees: int = 0) -> dict:
    """``bst.predict`` on ``rows``: transformed, raw, and raw over the
    first ``cascade_trees`` iterations where given."""
    out = {False: bst.predict(rows), True: bst.predict(rows, raw_score=True)}
    if cascade_trees:
        out["first"] = bst.predict(rows, raw_score=True,
                                   num_iteration=cascade_trees)
    return out


def stage1_margins(first: np.ndarray, k: int) -> np.ndarray:
    """The cascade's margin of each row's stage-1 raw score, in float32:
    2|s| for one class, top-1 minus top-2 for K."""
    s = np.asarray(first, np.float32).reshape(len(first), k)
    if k > 1:
        top2 = -np.sort(-s, axis=1)[:, :2]
        return top2[:, 0] - top2[:, 1]
    return np.float32(2) * np.abs(s[:, 0])


def cascade_emulation(first: np.ndarray, full: np.ndarray, k: int,
                      margin: float):
    """The cascade's rule on the host: a row whose stage-1 margin reaches
    ``margin`` keeps its stage-1 raw score, any other row the full
    model's. Returns (the scores, the rows kept)."""
    sure = stage1_margins(first, k) >= np.float32(margin)
    want = np.where(sure.reshape(-1, *([1] * (first.ndim - 1))), first, full)
    return want, int(sure.sum())


def http_post(host: str, port: int, body: dict) -> dict:
    import urllib.request
    return json.loads(urllib.request.urlopen(urllib.request.Request(
        "http://%s:%d/predict" % (host, port),
        data=json.dumps(body).encode()), timeout=120).read())


def latency_ms(fn, reps: int) -> list:
    """Host-clock milliseconds of ``reps`` calls of ``fn`` (each returns
    its result on the host, so each ends in a synchronise)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def drive_serving_path(cat_bst, mc_bst, tmp: str, dev) -> dict:
    """Path 4zx: serving (Queue 1 #10) on ``dev`` (the card). Trains the
    binary frontier model with the launch counts set to 0 just before and
    read just after, then serves it, ``cat_bst`` (4m), ``mc_bst`` (4r) and
    4m's model text reloaded through ``ModelRegistry.load_file``: requests
    of SERVE_SIZES rows through ``ServingEngine.predict``, a
    ``MicroBatchQueue`` from SERVE_THREADS threads, ``serve_stdin`` and
    ``make_server`` on 127.0.0.1, each response equal to ``predict`` on
    the same rows bit for bit, raw and transformed, with no graph capture
    after warmup; then the replay backend, the cascades, the quantized
    leaves and a hot roll. Prints each bucket's latency through the engine
    and through HTTP, rows a second at bucket 4,096, the captures of
    warmup and a graph's replay against the same entry run op by op."""
    import io
    import threading
    from lightgbm_tpu_torch import serving
    x, y = bench_data(MAIN_ROWS)
    t0 = time.perf_counter()
    ds = lgb.Dataset(x, label=y, params=PARAMS).construct()
    binning_s = time.perf_counter() - t0
    del x, y
    bst, train_s, launches, steps = train_counted(
        dict(PARAMS, **GROWTH_PARAMS["frontier"]), ds, rounds=SERVE_ROUNDS)
    del ds
    check_path_launches("4zx", "frontier", bst, launches, steps)
    bst.save_model(os.path.join(tmp, SERVE_MODEL))     # 4zzi serves it
    log("path 4zx: binning %.2f s, %d frontier iterations in %.2f s (%.3f s "
        "each), launches %s" % (binning_s, SERVE_ROUNDS, train_s,
                                train_s / SERVE_ROUNDS, launches))
    text_path = os.path.join(tmp, "serve_categorical.model.txt")
    cat_bst.save_model(text_path)
    text_bst = lgb.Booster(model_file=text_path)
    served = {"binary": (bst, bench_data(SERVE_ROWS, seed=1)[0]),
              "categorical": (cat_bst, categorical_data(SERVE_ROWS,
                                                        seed=1)[0]),
              "multiclass": (mc_bst, multiclass_data(SERVE_ROWS, seed=1)[0])}
    served["categorical_text"] = (text_bst, served["categorical"][1])
    t0 = time.perf_counter()
    refs = {name: serve_references(b, rows, SERVE_CASCADE.get(name, 0))
            for name, (b, rows) in served.items()}
    log("path 4zx: references (predict on %d rows, raw and transformed) "
        "%.2f s" % (SERVE_ROWS, time.perf_counter() - t0))
    checks = 0

    # ---- the engine, its warmup, and requests in process -------------
    eng = serving.ServingEngine(device=dev)
    for name in ("binary", "categorical", "multiclass"):
        eng.registry.register(served[name][0].as_serving_bundle(name))
    eng.registry.load_file("categorical_text", text_path)
    c0 = serving.backend_compile_count()
    t0 = time.perf_counter()
    warmed = eng.warmup(raw_scores=(False, True))
    warm_s = time.perf_counter() - t0
    warm_captures = serving.backend_compile_count() - c0
    log("path 4zx: warmup %.2f s, %d entries (4 models x %d buckets x raw "
        "and transformed), %d CUDA graphs captured"
        % (warm_s, warmed, len(serving.bucket_sizes()), warm_captures))
    if warm_captures != warmed:
        raise AssertionError("4zx: warmup captured %d graphs for %d entries"
                             % (warm_captures, warmed))
    for name, (_, rows) in served.items():
        for n in SERVE_SIZES:
            for raw in (False, True):
                require_equal(eng.predict(name, rows[:n], raw_score=raw),
                              refs[name][raw][:n],
                              "4zx engine %s %d rows raw=%s" % (name, n, raw))
                checks += 1

    # ---- the micro-batch queue from SERVE_THREADS threads -------------
    queue = serving.MicroBatchQueue(eng, deadline_ms=2.0).start()
    faults = []

    def caller(i):
        try:
            for name, (_, rows) in served.items():
                for n in SERVE_SIZES:
                    lo = (i * 997) % (SERVE_ROWS - n + 1)
                    raw = bool((i + n) % 2)
                    require_equal(queue.predict(name, rows[lo:lo + n],
                                                raw_score=raw),
                                  refs[name][raw][lo:lo + n],
                                  "4zx queue %s %d rows" % (name, n))
        except Exception as e:  # noqa: BLE001 - raised after the join
            faults.append(e)
    threads = [threading.Thread(target=caller, args=(i,))
               for i in range(SERVE_THREADS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    queue_s = time.perf_counter() - t0
    queue.stop()
    if faults or any(t.is_alive() for t in threads):
        raise AssertionError("4zx queue: %s" % (faults or "a caller hung"))
    checks += SERVE_THREADS * len(served) * len(SERVE_SIZES)
    log("path 4zx: queue, %d threads x %d requests in %.2f s"
        % (SERVE_THREADS, len(served) * len(SERVE_SIZES), queue_s))

    # ---- stdin and HTTP ------------------------------------------------
    app = serving.ServingApp(eng)
    srv = None
    try:
        lines, wants = [], []
        for name, (_, rows) in served.items():
            for n in (1, 17, 1_000):
                for raw in (False, True):
                    lines.append(json.dumps({"model": name, "raw_score": raw,
                                             "data": rows[:n].tolist()}))
                    wants.append((refs[name][raw][:n], name, n))
        reply = io.StringIO()
        if serving.serve_stdin(app, io.StringIO("\n".join(lines) + "\n"),
                               reply) != len(lines):
            raise AssertionError("4zx stdin: not every request was served")
        for line, (want, name, n) in zip(reply.getvalue().splitlines(),
                                         wants):
            require_equal(json.loads(line)["predictions"], want,
                          "4zx stdin %s %d rows" % (name, n))
            checks += 1
        srv = serving.make_server(app, "127.0.0.1", 0)
        host, port = srv.server_address
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        for name, (_, rows) in served.items():
            for n in SERVE_SIZES:
                raw = n in (17, 4_096)
                rep = http_post(host, port, {"model": name, "raw_score": raw,
                                             "data": rows[:n].tolist()})
                require_equal(rep["predictions"], refs[name][raw][:n],
                              "4zx HTTP %s %d rows" % (name, n))
                checks += 1
        rows = served["binary"][1]
        http_latency = {n: serving.latency_summary(latency_ms(
            lambda: http_post(host, port, {"model": "binary",
                                           "data": rows[:n].tolist()}),
            SERVE_LATENCY_REPS // 2)) for n in HTTP_LATENCY_SIZES}
    finally:
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        app.close()
    after = {"captures": eng.metrics.recompiles_after_warmup(),
             "cache_misses": eng.metrics.cache_misses_after_warmup()}
    if after["captures"] or after["cache_misses"]:
        raise AssertionError("4zx: %s after warmup" % after)

    # ---- latency by bucket, rows a second, graph against op by op ------
    rows = served["binary"][1]
    engine_latency = {b: serving.latency_summary(latency_ms(
        lambda: eng.predict("binary", rows[:b]), SERVE_LATENCY_REPS))
        for b in serving.bucket_sizes()}
    big = serving.bucket_sizes()[-1]
    t0 = time.perf_counter()
    for _ in range(SERVE_LATENCY_REPS):
        eng.predict("binary", rows[:big])
    rows_per_s = big * SERVE_LATENCY_REPS / (time.perf_counter() - t0)
    bundle = eng.registry.get("binary")
    entry = eng._predictor(bundle, big, False, bundle.total_iterations)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    graph_ms = time_ms(entry.replay, flush, reps=10)
    eager_ms = time_ms(lambda: entry.eager(entry._x), flush, reps=10)
    del flush
    log("path 4zx on %s" % card_line())
    for b, lat in engine_latency.items():
        log("path 4zx: bucket %5d through ServingEngine: p50 %.3f ms, p99 "
            "%.3f ms" % (b, lat["p50_ms"], lat["p99_ms"]))
    for n, lat in http_latency.items():
        log("path 4zx: %5d rows through HTTP: p50 %.3f ms, p99 %.3f ms"
            % (n, lat["p50_ms"], lat["p99_ms"]))
    log("path 4zx: %.0f rows a second at bucket %d (binary, %d trees); its "
        "graph replays in %.3f ms, the same entry op by op in %.3f ms"
        % (rows_per_s, big, len(bundle.host_models), graph_ms, eager_ms))

    # ---- a hot roll to a staged second model ---------------------------
    half_path = os.path.join(tmp, "serve_binary_50.model.txt")
    bst.save_model(half_path, num_iteration=SERVE_ROUNDS // 2)
    rows = served["binary"][1]
    half = bst.predict(rows[:1_000], num_iteration=SERVE_ROUNDS // 2)
    c0 = serving.backend_compile_count()
    staged = eng.stage_and_prewarm("binary", half_path,
                                   raw_scores=(False, True))
    roll_captures = serving.backend_compile_count() - c0
    if roll_captures < 2 * len(serving.bucket_sizes()):
        raise AssertionError("4zx: the staged model captured %d graphs "
                             "before the swap" % roll_captures)
    require_equal(eng.predict("binary", rows[:1_000]),
                  refs["binary"][False][:1_000], "4zx before the swap")
    eng.registry.register(staged, replace=True)
    require_equal(eng.predict("binary", rows[:1_000]), half,
                  "4zx after the swap")
    after_roll = {"captures": eng.metrics.recompiles_after_warmup(),
                  "cache_misses": eng.metrics.cache_misses_after_warmup()}
    if after_roll["captures"] or after_roll["cache_misses"]:
        raise AssertionError("4zx: %s after the hot roll" % after_roll)
    checks += 2
    log("path 4zx: hot roll captured %d graphs before the swap; captures "
        "and cache misses after warmup %s" % (roll_captures, after_roll))

    # ---- the replay backend, the cascades, the quantized leaves --------
    # (after the checks of captures: these engines capture graphs of their
    # own, which the process-wide count would read as the first engine's)
    replay = serving.ServingEngine(device=dev, backend="replay")
    for name in ("binary", "categorical", "multiclass"):
        replay.registry.register(served[name][0].as_serving_bundle(name))
        for n in ((16,) if name == "binary" else (16, 1_000)):
            rows = served[name][1]
            # the traversal's output on these rows is refs' (checked above)
            require_equal(replay.predict(name, rows[:n], raw_score=True),
                          refs[name][True][:n],
                          "4zx replay against traversal %s %d rows"
                          % (name, n))
            checks += 1
    cascade = {}
    for name, ct in SERVE_CASCADE.items():
        b, rows = served[name]
        k = b.num_model_per_iteration()
        ref = refs[name]
        median = float(np.median(stage1_margins(ref["first"][:1_000], k)))
        for margin in (float("inf"), 0.0, 10.0, median):
            ce = serving.ServingEngine(device=dev, cascade_trees=ct,
                                       cascade_margin=margin)
            ce.registry.register(b.as_serving_bundle(name))
            got = ce.predict(name, rows[:1_000], raw_score=True)
            want, sure = cascade_emulation(ref["first"][:1_000],
                                           ref[True][:1_000], k, margin)
            if margin == float("inf"):
                want = ref[True][:1_000]
            elif margin == 0.0:
                want = ref["first"][:1_000]
            require_equal(got, want, "4zx cascade %s margin %g"
                          % (name, margin))
            cascade["%s margin %g" % (name, margin)] = sure
            checks += 1
    log("path 4zx: cascades (first stage %s iterations), rows that keep "
        "their stage-1 score of 1,000: %s" % (SERVE_CASCADE, cascade))
    quant = serving.ServingEngine(device=dev, quantize_leaves=True)
    quant.registry.register(bst.as_serving_bundle("binary"))
    rows = served["binary"][1]
    got = quant.predict("binary", rows[:big], raw_score=True)
    full = refs["binary"][True][:big]
    quant_rel = float(np.max(np.abs(got - full)) / np.max(np.abs(full)))
    if not quant_rel <= SERVE_QUANT_REL:
        raise AssertionError("4zx: quantized leaves %.3g off the full scores "
                             "(relative to the largest), limit %g"
                             % (quant_rel, SERVE_QUANT_REL))
    log("path 4zx: quantized leaves %.3g off the full scores (relative to "
        "the largest |score|)" % quant_rel)
    log("path 4zx: %d checks passed" % checks)

    return {"launches": launches, "binning_s": binning_s, "train_s": train_s,
            "s_per_iter": train_s / SERVE_ROUNDS, "warmed": warmed,
            "warm_s": warm_s, "warm_captures": warm_captures,
            "engine_latency_ms": {str(b): v
                                  for b, v in engine_latency.items()},
            "http_latency_ms": {str(n): v for n, v in http_latency.items()},
            "rows_per_s": rows_per_s, "graph_ms": graph_ms,
            "eager_ms": eager_ms, "cascade_kept": cascade,
            "quantized_rel": quant_rel, "roll_captures": roll_captures,
            "queue_s": queue_s, "checks": checks}


def drive_bundled_path(label: str, ds, x, y, valid=None):
    """Phase 4i-4l: one growth mode on the bundled workload at full width,
    with the launch counts set to 0 just before and read just after; 4i
    also keeps ``valid`` (Dataset, rows), whose device scores must be the
    model's raw predictions."""
    growth = BUNDLED_PATHS[label]
    params = dict(PARAMS, **GROWTH_PARAMS[growth])
    binned = ds._binned
    c, b = binned.num_columns, binned.max_col_bins()
    kwargs = {} if valid is None else {"valid_sets": [valid[0]],
                                       "verbose_eval": False}
    bst, train_s, launches, steps = train_counted(params, ds, **kwargs)
    trees = len(bst.models)
    t0 = time.perf_counter()
    prob = bst.predict(x)
    predict_s = time.perf_counter() - t0
    train_auc = auc(prob, y)
    splits = splits_on_layout(bst.models, binned)
    plans = plan_lines(binned.num_data, c, b,
                       kernels._sm_count(torch.device("cuda", 0)))
    waves = launches[WAVE_KERNEL[growth]] if growth in WAVE_KERNEL else None
    out = {"growth": growth, "C": c, "B": b,
           "bundles": sum(len(f) > 1 and not p for f, p in
                          zip(binned.col_features, binned.col_packed)),
           "pairs": sum(binned.col_packed), "train_s": train_s,
           "s_per_iter": train_s / trees, "predict_s": predict_s,
           "auc": train_auc, "jax_auc": JAX_BUNDLED_AUC[growth],
           "leaves": [t.num_leaves_actual for t in bst.models],
           "waves_per_tree": None if waves is None else waves / trees,
           "splits_on": splits, "launches": launches,
           "plans": {w: plans[w] for w in PATH_KERNELS[growth]}}
    log("path %s (%s, bundled): C=%d B=%d, %d bundles, %d pairs; train %.2f "
        "s (%d iterations, %.3f s per iteration), predict %.3f s, trees %s "
        "leaves%s" % (label, growth, c, b, out["bundles"], out["pairs"],
                      train_s, trees, out["s_per_iter"], predict_s,
                      out["leaves"], "" if waves is None else
                      ", %.1f waves per tree" % out["waves_per_tree"]))
    for wrapper in PATH_KERNELS[growth]:
        for what, plan in plans[wrapper].items():
            log("path %s: plan of %s %s: %s" % (label, wrapper, what, plan))
    log("path %s: train AUC %.6f (JAX package %.6f), %d splits, %d on "
        "bundled and %d on packed features, launches %s"
        % (label, train_auc, out["jax_auc"], splits["splits"],
           splits["bundled"], splits["packed"], launches))
    check_path_launches(label, growth, bst, launches, steps)
    if trees != NUM_ITERS:
        raise AssertionError("path %s: expected %d trees, got %d"
                             % (label, NUM_ITERS, trees))
    if prob.shape != (len(x),) or not np.isfinite(prob).all():
        raise AssertionError("path %s: predictions are not finite [n] "
                             "probabilities" % label)
    if abs(train_auc - out["jax_auc"]) > AUC_TOLERANCE:
        raise AssertionError("path %s: train AUC %.6f is more than %g from "
                             "the JAX package's %.6f"
                             % (label, train_auc, AUC_TOLERANCE,
                                out["jax_auc"]))
    if splits["bundled"] < 1 or splits["packed"] < 1:
        raise AssertionError("path %s: no split on a bundled or on a packed "
                             "feature (%s)" % (label, splits))
    if valid is not None:
        scores = bst._impl.scores_of(1)
        raw = bst.predict(valid[1], raw_score=True)
        out["valid_score_max_diff"] = float(np.abs(scores - raw).max())
        log("path %s: device valid scores of %d rows against predict: max "
            "diff %.3g" % (label, len(raw), out["valid_score_max_diff"]))
        if out["valid_score_max_diff"] > VALID_SCORE_TOL:
            raise AssertionError("path %s: device valid scores differ from "
                                 "predict by %.3g"
                                 % (label, out["valid_score_max_diff"]))
    return out


def drive_categorical_path(label: str, ds, x, y, valid=None,
                           keep: Optional[dict] = None):
    """Phase 4m-4p: one growth mode on the categorical workload at full
    width, with the launch counts set to 0 just before and read just
    after; 4m also keeps ``valid`` (Dataset, rows), whose device scores
    must be the model's raw predictions, and round-trips its model
    text."""
    growth = CATEGORICAL_PATHS[label]
    params = dict(PARAMS, **GROWTH_PARAMS[growth])
    kwargs = {} if valid is None else {"valid_sets": [valid[0]],
                                       "verbose_eval": False}
    bst, train_s, launches, steps = train_counted(params, ds, **kwargs)
    trees = len(bst.models)
    t0 = time.perf_counter()
    prob = bst.predict(x)
    predict_s = time.perf_counter() - t0
    train_auc = auc(prob, y)
    splits = categorical_splits(bst.models)
    waves = launches[WAVE_KERNEL[growth]] if growth in WAVE_KERNEL else None
    out = {"growth": growth, "train_s": train_s,
           "s_per_iter": train_s / trees, "predict_s": predict_s,
           "auc": train_auc, "jax_auc": JAX_CATEGORICAL_AUC[growth],
           "leaves": [t.num_leaves_actual for t in bst.models],
           "waves_per_tree": None if waves is None else waves / trees,
           "splits_on": splits, "launches": launches}
    log("path %s (%s, categorical): train %.2f s (%d iterations, %.3f s per "
        "iteration), predict %.3f s, trees %s leaves%s"
        % (label, growth, train_s, trees, out["s_per_iter"], predict_s,
           out["leaves"], "" if waves is None else
           ", %.1f waves per tree" % out["waves_per_tree"]))
    log("path %s: train AUC %.6f (JAX package %.6f); %d splits, %d "
        "categorical, %d send more than one category left, widest raw "
        "bitset %d words, largest category sent left %d; launches %s"
        % (label, train_auc, out["jax_auc"], splits["splits"],
           splits["categorical"], splits["multi_category"],
           splits["widest_words"], splits["max_category"], launches))
    check_path_launches(label, growth, bst, launches, steps)
    if trees != NUM_ITERS:
        raise AssertionError("path %s: expected %d trees, got %d"
                             % (label, NUM_ITERS, trees))
    if prob.shape != (len(x),) or not np.isfinite(prob).all():
        raise AssertionError("path %s: predictions are not finite [n] "
                             "probabilities" % label)
    if abs(train_auc - out["jax_auc"]) > AUC_TOLERANCE:
        raise AssertionError("path %s: train AUC %.6f is more than %g from "
                             "the JAX package's %.6f"
                             % (label, train_auc, AUC_TOLERANCE,
                                out["jax_auc"]))
    if splits["categorical"] < 1 or splits["multi_category"] < 1:
        raise AssertionError("path %s: no categorical split, or none that "
                             "sends more than one category left (%s)"
                             % (label, splits))
    if valid is not None:
        scores = bst._impl.scores_of(1)
        raw = bst.predict(valid[1], raw_score=True)
        out["valid_score_max_diff"] = float(np.abs(scores - raw).max())
        loaded = lgb.Booster(model_str=bst.model_to_string())
        out["model_text_max_diff"] = float(np.abs(
            loaded.predict(x, raw_score=True)
            - bst.predict(x, raw_score=True)).max())
        log("path %s: device valid scores of %d rows against predict: max "
            "diff %.3g; the model text reloaded predicts the %d rows within "
            "%.3g" % (label, len(raw), out["valid_score_max_diff"], len(x),
                      out["model_text_max_diff"]))
        if out["valid_score_max_diff"] > VALID_SCORE_TOL:
            raise AssertionError("path %s: device valid scores differ from "
                                 "predict by %.3g"
                                 % (label, out["valid_score_max_diff"]))
        if out["model_text_max_diff"] > MODEL_TEXT_TOL:
            raise AssertionError("path %s: the reloaded model text predicts "
                                 "%.3g away" % (label,
                                                out["model_text_max_diff"]))
    out.update(iteration_counts(label, bst))
    if keep is not None:
        keep[label] = bst
    return out


def drive_fobj_path(ds, x, y):
    """Phase 4q: exact growth on bench.py's workload through a custom
    objective (``logistic_fobj``, numpy on the host), with the launch counts
    set to 0 just before and read just after; each iteration's round trip
    (the scores to the host, the fobj call, the gradients and hessians
    back) event-timed."""
    params = dict(PARAMS, **GROWTH_PARAMS["exact"], **FOBJ_PARAMS)
    custom = lgb.Booster._custom_gradients
    timer = EventTimer(custom)
    lgb.Booster._custom_gradients = lambda self, fobj: timer(self, fobj)
    try:
        bst, train_s, launches, steps = train_counted(params, ds,
                                                      fobj=logistic_fobj)
    finally:
        lgb.Booster._custom_gradients = custom
    trees = len(bst.models)
    raw = bst.predict(x)
    train_auc = auc(raw, y)
    out = {"growth": "exact", "train_s": train_s,
           "s_per_iter": train_s / trees, "auc": train_auc,
           "jax_auc": JAX_FOBJ_AUC, "launches": launches,
           "fobj_rounds": len(timer.events),
           "fobj_ms_per_iter": timer.total_ms() / trees}
    log("path 4q (exact, custom objective): train %.2f s (%d iterations, "
        "%.3f s per iteration), train AUC %.6f (JAX package %.6f), fobj "
        "round trip %.3f ms per iteration, launches %s"
        % (train_s, trees, out["s_per_iter"], train_auc, JAX_FOBJ_AUC,
           out["fobj_ms_per_iter"], launches))
    check_path_launches("4q", "exact", bst, launches, steps)
    if trees != NUM_ITERS or len(timer.events) != NUM_ITERS:
        raise AssertionError("path 4q: %d trees and %d fobj rounds, not %d"
                             % (trees, len(timer.events), NUM_ITERS))
    if bst._impl.objective is not None or not np.isfinite(raw).all():
        raise AssertionError("path 4q: an objective ran, or the raw scores "
                             "are not finite")
    if abs(train_auc - JAX_FOBJ_AUC) > AUC_TOLERANCE:
        raise AssertionError("path 4q: train AUC %.6f is more than %g from "
                             "the JAX package's %.6f"
                             % (train_auc, AUC_TOLERANCE, JAX_FOBJ_AUC))
    out.update(iteration_counts("4q", bst, fobj=logistic_fobj))
    return out


@contextlib.contextmanager
def patched(*targets):
    """Set each (owner, name, value) of ``targets`` for the block, and put
    the old values back after it."""
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in targets]
    for owner, name, value in targets:
        setattr(owner, name, value)
    try:
        yield
    finally:
        for owner, name, value in saved:
            setattr(owner, name, value)


def queries_whole(masks, sizes) -> bool:
    """Whether every query lies wholly in or wholly out of every mask."""
    cuts = np.cumsum(sizes)[:-1]
    return all(q.min() == q.max() for m in masks
               for q in np.split(m.cpu().numpy(), cuts))


def drive_sampling_path(label: str, ds, x, y, dense: dict, valid=None):
    """Phase 4zb-4zf: a row-sampling path at full width on bench.py's
    workload (SAMPLING_PATHS), with the launch counts set to 0 just before
    and read just after, beside ``dense``, the dense binary path of the same
    growth mode; ``valid`` (Dataset, rows) where the path keeps one. The
    mask draws, GOSS's selection and DART's drop-and-normalize replay are
    event-timed; DART's drop sets are recorded."""
    growth, extra, _, rounds, _ = SAMPLING_PATHS[label]
    params = dict(PARAMS, **extra, **GROWTH_PARAMS[growth])
    boosting = params.get("boosting", "gbdt")
    ref = JAX_SAMPLING_METRIC[label]
    draw = EventTimer(port_gbdt.GBDT._draw_bag_mask)
    select = EventTimer(port_goss.goss_multipliers)
    replay = EventTimer(lambda impl, fn, *args: fn(impl, *args))
    mults, drops = [], []
    drop, put_back = port_dart.DART._drop, port_dart.DART._put_back

    def selected(*args):
        mults.append(select(*args))
        return mults[-1]

    def dropped(impl, index):
        drops.append(list(index))
        return replay(impl, drop, index)
    kwargs, evals = {}, {}
    if valid is not None:
        kwargs = {"valid_sets": [valid[0]], "evals_result": evals,
                  "verbose_eval": False}
        if boosting == "gbdt":
            kwargs["early_stopping_rounds"] = EARLY_STOPPING_ROUNDS
    with patched((port_gbdt.GBDT, "_draw_bag_mask",
                  lambda impl, key: draw(impl, key)),
                 (port_goss, "goss_multipliers", selected),
                 (port_dart.DART, "_drop", dropped),
                 (port_dart.DART, "_put_back",
                  lambda impl, outputs, factor: replay(impl, put_back,
                                                       outputs, factor))):
        bst, train_s, launches, steps = train_counted(params, ds, rounds,
                                                      **kwargs)
    trees = len(bst.models)
    prob = bst.predict(x, num_iteration=rounds)
    train_auc = auc(prob, y)
    waves = launches[WAVE_KERNEL[growth]] if growth in WAVE_KERNEL else None
    out = {"growth": growth, "params": extra, "train_s": train_s,
           "s_per_iter": train_s / rounds,
           "x_dense": train_s / rounds / dense["s_per_iter"],
           "auc": train_auc, "jax_auc": ref["auc"],
           "auc_gap": abs(train_auc - ref["auc"]),
           "leaves": [t.num_leaves_actual for t in bst.models],
           "waves_per_tree": None if waves is None else waves / trees,
           "launches": launches,
           "mask_draws": len(draw.events),
           "mask_draw_ms": (draw.total_ms() / len(draw.events)
                            if draw.events else None),
           "goss_select_ms": (select.total_ms() / len(select.events)
                              if select.events else None),
           "dart_replay_ms_per_iter": (replay.total_ms() / rounds
                                       if replay.events else None)}
    log("path %s (%s, %s): train %.2f s (%d iterations, %.3f s per "
        "iteration, %.2fx the dense binary path's %.3f), trees %s leaves%s; "
        "train AUC %.6f (JAX package %.6f); %d mask draws of %s ms, GOSS "
        "selection %s ms, DART replay %s ms an iteration; launches %s" % (
            label, growth, boosting, train_s, rounds, out["s_per_iter"],
            out["x_dense"], dense["s_per_iter"], out["leaves"],
            "" if waves is None
            else ", %.1f waves per tree" % out["waves_per_tree"], train_auc,
            ref["auc"], out["mask_draws"], fmt(out["mask_draw_ms"]),
            fmt(out["goss_select_ms"]),
            fmt(out["dart_replay_ms_per_iter"]), launches))
    check_path_launches(label, growth, bst, launches, steps)
    if trees != rounds or any(n < 2 for n in out["leaves"]):
        raise AssertionError("path %s: expected %d trees that split, got %s"
                             % (label, rounds, out["leaves"]))
    if prob.shape != (len(x),) or not np.isfinite(prob).all():
        raise AssertionError("path %s: predictions are not finite [n] "
                             "probabilities" % label)
    if out["auc_gap"] > AUC_TOLERANCE:
        raise AssertionError("path %s: train AUC %.6f is more than %g from "
                             "the JAX package's %.6f" % (
                                 label, train_auc, AUC_TOLERANCE,
                                 ref["auc"]))
    if "bagging_freq" in extra:
        want = len(range(0, rounds, extra["bagging_freq"]))
        if len(draw.events) != want:
            raise AssertionError("path %s: %d mask draws, not %d"
                                 % (label, len(draw.events), want))
    if boosting == "goss":
        check_goss_counts(label, mults, len(y), params, rounds)
        out["goss"] = [{"top": int((m == 1).sum()),
                        "others": int((m > 1).sum())} for m in mults]
    if boosting == "dart":
        out["drops"] = drops
        log("path %s: drop sets %s (JAX package %s)"
            % (label, drops, ref["drops"]))
        if drops != ref["drops"]:
            raise AssertionError("path %s: drop sets differ from the JAX "
                                 "package's" % label)
    if valid is not None:
        xv = valid[1]
        raw = bst.predict(xv, raw_score=True, num_iteration=rounds)
        out["valid_score_max_diff"] = float(np.abs(
            bst._impl.scores_of(1) - raw).max())
        log("path %s: device valid scores of %d rows against predict: max "
            "diff %.3g" % (label, len(raw), out["valid_score_max_diff"]))
        if out["valid_score_max_diff"] > VALID_SCORE_TOL:
            raise AssertionError("path %s: device valid scores differ from "
                                 "predict by %.3g"
                                 % (label, out["valid_score_max_diff"]))
        if "valid" in ref:
            out["valid"] = evals["valid_0"]["auc"]
            out["jax_valid"] = ref["valid"]
            out["best_iteration"] = bst.best_iteration
            gaps = [abs(v - r) for v, r in zip(out["valid"], ref["valid"])]
            out["valid_max_gap"] = max(gaps)
            log("path %s: valid AUC %s (JAX package %s), best iteration %d "
                "(JAX package %d)" % (label, out["valid"], ref["valid"],
                                      bst.best_iteration,
                                      ref["best_iteration"]))
            if len(gaps) != len(ref["valid"]) or max(gaps) > AUC_TOLERANCE:
                raise AssertionError("path %s: valid AUC more than %g from "
                                     "the JAX package's" % (label,
                                                            AUC_TOLERANCE))
    if boosting in ("dart", "rf"):
        text = bst.model_to_string()
        loaded = lgb.Booster(model_str=text)
        out["model_text_max_diff"] = float(np.abs(
            loaded.predict(x, raw_score=True)
            - bst.predict(x, raw_score=True)).max())
        log("path %s: the model text (average_output %s) reloaded predicts "
            "the %d rows within %.3g" % (
                label, "average_output" in text.split("feature_names")[0],
                len(x), out["model_text_max_diff"]))
        if (boosting == "rf") != ("\naverage_output\n" in text):
            raise AssertionError("path %s: average_output is %s the model "
                                 "text" % (label, "missing from"
                                           if boosting == "rf" else "in"))
        if out["model_text_max_diff"] > MODEL_TEXT_TOL:
            raise AssertionError("path %s: the reloaded model text predicts "
                                 "%.3g away"
                                 % (label, out["model_text_max_diff"]))
    out.update(iteration_counts(label, bst))
    return out


def drive_constraint_path(label: str, ds, x, y, dense: dict,
                          directory: str) -> dict:
    """Phase 4zh-4zm: a constraint path at full width (CONSTRAINT_PATHS),
    with the launch counts set to 0 just before and read just after,
    beside ``dense``, the dense binary path of the same growth mode.
    Monotone paths are held to the JAX package's train l2 and checked
    monotone on a grid; 4zl's trees must split nodes 0-3 as forced, through
    the hist_for_leaf route; 4zm must keep the JAX package's AUC, features
    and final feature_used."""
    growth, kind = CONSTRAINT_PATHS[label]
    extra = constraint_params(kind, directory)
    params = dict(PARAMS, **extra, **GROWTH_PARAMS[growth])
    ref = JAX_CONSTRAINT_METRIC[label]
    bst, train_s, launches, steps = train_counted(params, ds)
    impl = bst._impl
    trees = len(bst.models)
    out = {"growth": growth, "kind": kind, "train_s": train_s,
           "s_per_iter": train_s / trees,
           "x_dense": train_s / trees / dense["s_per_iter"],
           "leaves": [t.num_leaves_actual for t in bst.models],
           "launches": launches}
    checks = []
    if kind == "monotone":
        (_, metric, value, _), = bst.eval_train()
        out.update(metric=metric, train=value, jax_train=ref["train"],
                   rel_gap=abs(value - ref["train"]) / abs(ref["train"]),
                   violation=monotone_violation(
                       lambda p: bst.predict(p, raw_score=True), x),
                   splits_on={str(f): int(sum(
                       (t.split_feature[:t.num_leaves_actual - 1] == f).sum()
                       for t in bst.models)) for f in (0, 1)})
        log("path %s (%s, monotone %s): train %s %.6f (JAX package %.6f, "
            "%.3g relative), largest step against the constraints on the "
            "grid %.3g, splits on features 0 / 1: %s (JAX package %s)" % (
                label, growth, MONOTONE_CONSTRAINTS[:2], metric, value,
                ref["train"], out["rel_gap"], out["violation"],
                out["splits_on"], ref["splits_on"]))
        checks += [(out["rel_gap"] > METRIC_REL_TOL, "train %s %.6f is %.3g "
                    "relative from the JAX package's" % (
                        metric, value, out["rel_gap"])),
                   (out["violation"] > MONO_GRID_TOL, "predictions step "
                    "%.3g against the constraints" % out["violation"])]
    else:
        out["auc"] = auc(bst.predict(x), y)
        out.update(jax_auc=ref["auc"], auc_gap=abs(out["auc"] - ref["auc"]))
        checks.append((out["auc_gap"] > AUC_TOLERANCE, "train AUC %.6f is "
                       "more than %g from the JAX package's %.6f" % (
                           out["auc"], AUC_TOLERANCE, ref["auc"])))
    if kind == "forced":
        got, want = forced_nodes(bst.models, impl.train_data)
        out["hist_for_leaf_launches"] = launches["build_histogram_leaf_cuda"]
        log("path %s: train AUC %.6f (JAX package %.6f); nodes 0-3 of every "
            "tree %s (forced %s); hist_for_leaf launches %d" % (
                label, out["auc"], ref["auc"],
                "as forced" if got == [want] * trees else got, want,
                out["hist_for_leaf_launches"]))
        checks += [(got != [want] * trees, "nodes 0-3 are not the forced "
                    "splits"),
                   (out["hist_for_leaf_launches"] < trees, "the "
                    "hist_for_leaf route launched %d times in %d trees"
                    % (out["hist_for_leaf_launches"], trees))]
    if kind == "cegb":
        state = impl._cegb.state
        out.update(split_features=split_features(bst.models),
                   feature_used=torch.nonzero(state.feature_used)[:, 0]
                   .tolist(), row_used_shape=list(state.row_used.shape))
        log("path %s: train AUC %.6f (JAX package %.6f), trees %s leaves "
            "(JAX package %s), split on features %s (JAX package %s), "
            "feature_used %s (JAX package %s), row_used %s uint8 on the "
            "card" % (label, out["auc"], ref["auc"], out["leaves"],
                      ref["leaves"], out["split_features"],
                      ref["split_features"], out["feature_used"],
                      ref["feature_used"], out["row_used_shape"]))
        checks += [(out["split_features"] != ref["split_features"],
                    "the trees split on other features than the JAX "
                    "package's"),
                   (out["feature_used"] != ref["feature_used"],
                    "feature_used differs from the JAX package's"),
                   (out["row_used_shape"] != [NUM_FEATURES, len(y)],
                    "row_used is not [F, N]")]
    log("path %s: train %.2f s (%d iterations, %.3f s per iteration, %.2fx "
        "the dense binary path's %.3f), trees %s leaves, launches %s" % (
            label, train_s, trees, out["s_per_iter"], out["x_dense"],
            dense["s_per_iter"], out["leaves"], launches))
    check_path_launches(label, growth, bst, launches, steps)
    if trees != NUM_ITERS or any(n < 2 for n in out["leaves"]):
        raise AssertionError("path %s: expected %d trees that split, got %s"
                             % (label, NUM_ITERS, out["leaves"]))
    for bad, what in checks:
        if bad:
            raise AssertionError("path %s: %s" % (label, what))
    out.update(iteration_counts(label, bst))
    return out


def check_goss_counts(label: str, mults, n: int, params,
                      rounds: int) -> None:
    """Each sampled GOSS iteration keeps at least its top share (more where
    rows tie at the threshold: a leaf's rows share g and h) and of the rest
    close to the expected share; the warm-up draws nothing."""
    warmup = int(1.0 / params["learning_rate"])
    top_cnt, other_cnt = port_goss.goss_counts(n, params["top_rate"],
                                               params["other_rate"])
    for i, m in enumerate(mults):
        tops, others = int((m == 1).sum()), int((m > 1).sum())
        expect = (n - tops) * other_cnt / (n - top_cnt)
        log("path %s: GOSS iteration %d keeps %d top rows (at least %d) "
            "and %d others (expected %.0f, %.2f%% off)" % (
                label, warmup + i, tops, top_cnt, others, expect,
                100 * abs(others - expect) / expect))
        if tops < top_cnt or abs(others - expect) > GOSS_OTHERS_REL * expect:
            raise AssertionError("path %s: GOSS kept %d top and %d other "
                                 "rows" % (label, tops, others))
    if len(mults) != rounds - warmup:
        raise AssertionError("path %s: GOSS sampled %d iterations, not %d"
                             % (label, len(mults), rounds - warmup))


def time_mask_draw(dev, flush) -> dict:
    """One bagging draw of MAIN_ROWS threefry uniforms on the card (int64
    torch ops), event-timed, and held bit-equal to the same draw on the
    CPU."""
    key = port_random.split(port_random.prng_key(3))[1]
    got = port_random.uniform(key, MAIN_ROWS, dev)
    want = port_random.uniform(key, MAIN_ROWS, "cpu")
    if not torch.equal(got.cpu().view(torch.int32), want.view(torch.int32)):
        raise AssertionError("the card's threefry draw differs from the "
                             "CPU's")
    ms = time_ms(lambda: port_random.uniform(key, MAIN_ROWS, dev), flush)
    # each value's 8 bytes of counter read and 4 written, once
    bound_ms, _ = bound(12 * MAIN_ROWS, 0)
    log("mask draw: %d threefry uniforms on the card in %.4f ms (bytes "
        "bound %.4f ms), bit-equal to the CPU's" % (MAIN_ROWS, ms, bound_ms))
    return {"rows": MAIN_ROWS, "ms": ms, "bound_ms": bound_ms}


def drive_multiclass_path(label: str, ds, x, valid=None,
                          keep: Optional[dict] = None):
    """Phase 4r-4u: one multiclass path at full width (NUM_CLASS trees an
    iteration, one a class), with the launch counts set to 0 just before
    and read just after; 4r also keeps ``valid`` (Dataset, rows), with
    early stopping, whose device scores must be the model's raw
    predictions, and round-trips its model text."""
    growth, objective = MULTICLASS_PATHS[label]
    params = dict(PARAMS, objective=objective, **objective_params(objective),
                  **GROWTH_PARAMS[growth])
    ref = JAX_MULTICLASS_METRIC[label]
    kwargs, evals = {}, {}
    if valid is not None:
        kwargs = {"valid_sets": [valid[0]], "evals_result": evals,
                  "early_stopping_rounds": EARLY_STOPPING_ROUNDS,
                  "verbose_eval": False}
    bst, train_s, launches, steps = train_counted(params, ds, **kwargs)
    trees = len(bst.models)
    t0 = time.perf_counter()
    prob = bst.predict(x)
    predict_s = time.perf_counter() - t0
    train = {name: value for _, name, value, _ in bst.eval_train()}
    waves = launches[WAVE_KERNEL[growth]] if growth in WAVE_KERNEL else None
    out = {"growth": growth, "objective": objective, "train_s": train_s,
           "s_per_iter": train_s / NUM_ITERS, "predict_s": predict_s,
           "train": train, "jax_train": ref["train"],
           "leaves": [t.num_leaves_actual for t in bst.models],
           "waves_per_tree": None if waves is None else waves / trees,
           "launches": launches}
    log("path %s (%s, %s, %d classes): train %.2f s (%d iterations, %d "
        "trees, %.3f s per iteration), predict %.3f s, trees %s leaves%s"
        % (label, growth, objective, NUM_CLASS, train_s, NUM_ITERS, trees,
           out["s_per_iter"], predict_s, out["leaves"], "" if waves is None
           else ", %.1f waves per tree" % out["waves_per_tree"]))
    log("path %s: train multi_logloss %.6f (JAX package %.6f), multi_error "
        "%.6f; launches %s" % (label, train["multi_logloss"], ref["train"],
                               train["multi_error"], launches))
    check_path_launches(label, growth, bst, launches, steps)
    if trees != NUM_ITERS * NUM_CLASS:
        raise AssertionError("path %s: expected %d trees, got %d"
                             % (label, NUM_ITERS * NUM_CLASS, trees))
    if any(n < 2 for n in out["leaves"]):
        raise AssertionError("path %s: a class tree did not split (%s)"
                             % (label, out["leaves"]))
    if prob.shape != (len(x), NUM_CLASS) or not np.isfinite(prob).all():
        raise AssertionError("path %s: predictions are not finite [n, %d] "
                             "probabilities" % (label, NUM_CLASS))
    checks = [("train multi_logloss", train["multi_logloss"], ref["train"])]
    if valid is not None:
        xv = valid[1]
        scores = bst._impl.scores_of(1)
        raw = bst.predict(xv, raw_score=True)
        out["valid"] = evals["valid_0"]["multi_logloss"]
        out["jax_valid"] = ref["valid"]
        out["valid_score_max_diff"] = float(np.abs(scores - raw).max())
        loaded = lgb.Booster(model_str=bst.model_to_string())
        out["model_text_max_diff"] = float(np.abs(
            loaded.predict(x, raw_score=True)
            - bst.predict(x, raw_score=True)).max())
        log("path %s: valid multi_logloss %s (JAX package %s), best "
            "iteration %d; device valid scores of %d rows against predict: "
            "max diff %.3g; the model text reloaded predicts the %d rows "
            "within %.3g" % (label, out["valid"], ref["valid"],
                             bst.best_iteration, len(raw),
                             out["valid_score_max_diff"], len(x),
                             out["model_text_max_diff"]))
        if out["valid_score_max_diff"] > VALID_SCORE_TOL:
            raise AssertionError("path %s: device valid scores differ from "
                                 "predict by %.3g"
                                 % (label, out["valid_score_max_diff"]))
        if out["model_text_max_diff"] > MODEL_TEXT_TOL:
            raise AssertionError("path %s: the reloaded model text predicts "
                                 "%.3g away" % (label,
                                                out["model_text_max_diff"]))
        if len(out["valid"]) != len(ref["valid"]):
            raise AssertionError("path %s: %d valid evaluations, the JAX "
                                 "package %d" % (label, len(out["valid"]),
                                                 len(ref["valid"])))
        checks += [("valid multi_logloss at iteration %d" % (i + 1), v, r)
                   for i, (v, r) in enumerate(zip(out["valid"],
                                                  ref["valid"]))]
    gaps = [abs(v - r) / abs(r) for _, v, r in checks]
    out["max_rel_gap"] = max(gaps)
    for (what, value, want), gap in zip(checks, gaps):
        if gap > METRIC_REL_TOL:
            raise AssertionError("path %s: %s %.6f is %.3g relative from "
                                 "the JAX package's %.6f"
                                 % (label, what, value, gap, want))
    out.update(iteration_counts(label, bst))
    if keep is not None:
        keep[label] = bst
    return out


class EventTimer:
    """A function wrapped in CUDA events: the summed time from the start
    event before each call to the end event after it, read after a
    synchronise (the device time of the call's work plus any gap while the
    host issued it)."""

    def __init__(self, fn):
        self.fn = fn
        self.events = []

    def __call__(self, *args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.fn(*args)
        end.record()
        self.events.append((start, end))
        return out

    def total_ms(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


def drive_regression_path(label: str, ds, valid):
    """Phase 4e-4h: one regression path at full width, with the launch
    counts set to 0 just before and read just after; renewal and the
    valid-set update timed with events."""
    growth, extra = REGRESSION_PATHS[label]
    params = dict(PARAMS, **GROWTH_PARAMS[growth], **extra)
    ref = JAX_REFERENCE_METRIC[label]
    renew_timer = EventTimer(port_gbdt.renew_leaf_values)
    valid_timer = EventTimer(port_gbdt.GBDT._update_valid_scores)
    update_valid = port_gbdt.GBDT._update_valid_scores
    kwargs, evals = {}, {}
    if "valid" in ref:
        kwargs = {"valid_sets": [valid[0]], "evals_result": evals,
                  "early_stopping_rounds": EARLY_STOPPING_ROUNDS,
                  "verbose_eval": False}
    port_gbdt.renew_leaf_values = renew_timer
    port_gbdt.GBDT._update_valid_scores = \
        lambda impl, ht: valid_timer(impl, ht)
    try:
        reset_counts()
        t0 = time.perf_counter()
        bst = lgb.train(params, ds, num_boost_round=NUM_ITERS, **kwargs)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    finally:
        port_gbdt.renew_leaf_values = renew_timer.fn
        port_gbdt.GBDT._update_valid_scores = update_valid
    launches = read_counts()
    trees = len(bst.models)
    (_, metric, train_value, _), = bst.eval_train()
    out = {"growth": growth, "params": extra, "train_s": train_s,
           "s_per_iter": train_s / trees, "metric": metric,
           "train": train_value, "jax_train": ref["train"],
           "leaves": [t.num_leaves_actual for t in bst.models],
           "launches": launches,
           "renew_ms_per_iter": (renew_timer.total_ms() / trees
                                 if renew_timer.events else None),
           "valid_update_ms_per_iter": (valid_timer.total_ms() / trees
                                        if valid_timer.events else None)}
    log("path %s (%s, %s): train %.2f s (%d iterations, %.3f s per "
        "iteration), trees %s leaves, train %s %.6f (JAX package %s), "
        "renewal %s ms per iteration, valid update %s ms per iteration, "
        "launches %s" % (label, growth, extra["objective"], train_s, trees,
                         out["s_per_iter"], out["leaves"], metric,
                         train_value, ref["train"],
                         fmt(out["renew_ms_per_iter"]),
                         fmt(out["valid_update_ms_per_iter"]), launches))
    for name in PATH_KERNELS[growth]:
        if launches[name] <= 0:
            raise AssertionError("path %s never launched %s" % (label, name))
    if trees != NUM_ITERS:
        raise AssertionError("path %s: expected %d trees, got %d"
                             % (label, NUM_ITERS, trees))
    if (renew_timer.events != []) != (extra["objective"] in (
            "quantile", "regression_l1", "mape")):
        raise AssertionError("path %s: renewal ran %d times"
                             % (label, len(renew_timer.events)))
    checks = [("train " + metric, train_value, ref["train"])]
    if "valid" in ref:
        xv = valid[1]
        scores = bst._impl.scores_of(1)
        raw = bst.predict(xv, raw_score=True)
        out["valid"] = evals["valid_0"][metric]
        out["jax_valid"] = ref["valid"]
        out["valid_score_max_diff"] = float(np.abs(scores - raw).max())
        log("path %s: valid %s %s (JAX package %s), device valid scores "
            "against predict: max diff %.3g, best iteration %d"
            % (label, metric, out["valid"], ref["valid"],
               out["valid_score_max_diff"], bst.best_iteration))
        if out["valid_score_max_diff"] > VALID_SCORE_TOL:
            raise AssertionError("path %s: device valid scores differ from "
                                 "predict by %.3g" % (
                                     label, out["valid_score_max_diff"]))
        if len(out["valid"]) != len(ref["valid"]):
            raise AssertionError("path %s: %d valid evaluations, the JAX "
                                 "package %d" % (label, len(out["valid"]),
                                                 len(ref["valid"])))
        checks += [("valid %s at iteration %d" % (metric, i + 1), v, r)
                   for i, (v, r) in enumerate(zip(out["valid"],
                                                  ref["valid"]))]
    gaps = [abs(v - r) / abs(r) for _, v, r in checks]
    out["max_rel_gap"] = max(gaps)
    for (what, value, want), gap in zip(checks, gaps):
        if gap > METRIC_REL_TOL:
            raise AssertionError("path %s: %s %.6f is %.3g relative from "
                                 "the JAX package's %.6f"
                                 % (label, what, value, gap, want))
    return out


def time_renewal(dev) -> dict:
    """Renewal alone at the main path's size: 1,000,000 rows in 255 leaves,
    unit weights, every row in the sample, and the stable sort of 1M
    float32 residuals it starts with; event-timed medians, L2 evicted."""
    r = np.random.RandomState(17)
    resid = torch.as_tensor(r.randn(MAIN_ROWS).astype(np.float32), device=dev)
    leaf_id = torch.as_tensor(r.randint(0, 255, MAIN_ROWS), device=dev)
    ones = torch.ones(MAIN_ROWS, device=dev)
    orig = torch.zeros(255, device=dev)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    out = {"renew_ms": time_ms(lambda: renew.renew_leaf_values(
        resid, ones, leaf_id, ones, 255, 0.9, orig), flush),
        "sort_ms": time_ms(lambda: torch.sort(resid, stable=True), flush)}
    log("renewal alone, %d rows, 255 leaves: %.4f ms; one stable sort of "
        "the residuals %.4f ms" % (MAIN_ROWS, out["renew_ms"],
                                   out["sort_ms"]))
    return out


def lambdarank_plain64(s, label, label_gain, max_position: int = 20,
                       sigmoid: float = 1.0):
    """Lambdarank's gradients and hessians of one query in float64 numpy,
    straight from rank_objective.hpp's formulas: docs ranked by a stable
    sort of -score, discounts 1/log2(2 + rank), and for each pair with the
    higher label first the |ΔNDCG| (divided by 0.01 + |Δscore| where the
    query's scores differ) times the sigmoid lambda."""
    s = np.asarray(s, np.float64)
    label = np.asarray(label, np.int64)
    n = len(s)
    gain = np.asarray(label_gain, np.float64)[label]
    rank = np.empty(n, np.int64)
    rank[np.argsort(-s, kind="stable")] = np.arange(n)
    disc = 1.0 / np.log2(2.0 + rank)
    ideal = np.sort(gain)[::-1][:max_position]
    max_dcg = float(np.sum(ideal / np.log2(2.0 + np.arange(len(ideal)))))
    g, h = np.zeros(n), np.zeros(n)
    if max_dcg <= 0:
        return g, h
    ds = s[:, None] - s[None, :]
    delta = (np.abs(disc[:, None] - disc[None, :])
             * (gain[:, None] - gain[None, :]) / max_dcg)
    if s.max() != s.min():
        delta = delta / (0.01 + np.abs(ds))
    p = 2.0 / (1.0 + np.exp(2.0 * sigmoid * ds))
    pair = label[:, None] > label[None, :]
    lam = np.where(pair, -p * delta, 0.0)
    hes = np.where(pair, 2.0 * p * (2.0 - p) * delta, 0.0)
    return lam.sum(1) - lam.sum(0), hes.sum(1) + hes.sum(0)


def lambdarank_bound(sizes) -> tuple:
    """(bound ms, what bounds it) of one lambdarank gradient over queries
    of ``sizes`` docs: each doc's score and label read and its gradient and
    hessian written once, against LAMBDARANK_PAIR_OPS float32 operations a
    pair of each query's docs."""
    sizes = np.asarray(sizes, np.int64)
    return bound(int(sizes.sum()) * 16,
                 LAMBDARANK_PAIR_OPS * int((sizes ** 2).sum()))


def check_lambdarank_at_scale(dev) -> dict:
    """The lambdarank gradient on the card at MSLR-WEB30K's shape:
    MSLR_QUERIES queries of 1 to MSLR_MAX_DOCS docs (exponential lengths of
    mean MSLR_MEAN_DOCS from seed 23, one query at the most), labels 0-4 in
    MSLR's skew and scores from the seed. Times one call (CUDA events,
    median), reads the peak memory it allocates, and holds it to
    ``lambdarank_plain64`` on a seeded sample of queries and the longest
    one. The JAX package's padded layout would need one [Q, M, M] float32
    array of Q * M * M * 4 bytes here."""
    r = np.random.RandomState(23)
    sizes = np.clip(np.round(r.exponential(MSLR_MEAN_DOCS, MSLR_QUERIES)),
                    1, MSLR_MAX_DOCS).astype(np.int64)
    sizes[r.randint(MSLR_QUERIES)] = MSLR_MAX_DOCS
    n = int(sizes.sum())
    label = r.choice(5, n, p=[0.5, 0.3, 0.15, 0.04, 0.01])
    score = r.randn(n).astype(np.float32)
    meta = Metadata(n)
    meta.set_label(label)
    meta.set_query(sizes)
    cfg = Config({"objective": "lambdarank"})
    t0 = time.perf_counter()
    obj = port_objectives.LambdarankNDCG(cfg)
    obj.init(meta, dev)
    init_s = time.perf_counter() - t0
    s_dev = torch.as_tensor(score, device=dev)
    obj.get_gradients(s_dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    g, h = obj.get_gradients(s_dev)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        obj.get_gradients(s_dev)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    g, h = g.cpu().numpy(), h.cpu().numpy()
    qb = np.concatenate([[0], np.cumsum(sizes)])
    sample = np.unique(np.concatenate([
        [int(np.argmax(sizes))],
        np.random.RandomState(24).choice(MSLR_QUERIES, RANK_SCALE_SAMPLE,
                                         replace=False)]))
    worst = 0.0
    for q in sample:
        lo, hi = qb[q], qb[q + 1]
        g64, h64 = lambdarank_plain64(score[lo:hi], label[lo:hi],
                                      port_objectives.default_label_gain())
        for got, want in ((g[lo:hi], g64), (h[lo:hi], h64)):
            scale = np.abs(want).sum()
            if scale > 0:
                worst = max(worst, float(np.abs(got - want).max() / scale))
    padded = MSLR_QUERIES * MSLR_MAX_DOCS ** 2 * 4
    bound_ms, bound_by = lambdarank_bound(sizes)
    out = {"queries": MSLR_QUERIES, "docs": n,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "longest": int(sizes.max()), "chunks": len(obj.chunks),
           "init_s": init_s, "ms": statistics.median(times),
           "peak_bytes": peak, "peak_over_inputs": peak - base,
           "cap_bytes": (port_objectives.PAIR_PEAK_ARRAYS
                         * port_objectives.PAIR_BYTES_CAP),
           "padded_bytes": padded, "max_rel_err": worst,
           "sampled_queries": len(sample)}
    log("lambdarank gradient at MSLR-WEB30K's shape: %d queries, %d docs "
        "(longest %d) in %d chunks, set up in %.2f s; %.4f ms a call "
        "(median of 5; bound %.4f ms by %s); max_memory_allocated %d "
        "bytes, %d over its inputs "
        "(cap %d = %d arrays of %d); the padded layout's one [Q, M, M] "
        "array would be %d bytes; against float64 on %d queries: %.3g of "
        "a query's sum of |g| (limit %g)" % (
            MSLR_QUERIES, n, out["longest"], out["chunks"], init_s,
            out["ms"], bound_ms, bound_by, peak, peak - base,
            out["cap_bytes"],
            port_objectives.PAIR_PEAK_ARRAYS, port_objectives.PAIR_BYTES_CAP,
            padded, len(sample), worst,
            RANK_SCALE_REL))
    if worst > RANK_SCALE_REL:
        raise AssertionError("the lambdarank gradient at scale is %.3g of a "
                             "query's |g| from float64" % worst)
    if peak - base > out["cap_bytes"]:
        raise AssertionError("the lambdarank gradient took %d bytes over its "
                             "inputs, more than its cap %d"
                             % (peak - base, out["cap_bytes"]))
    return out


def timed_gradients(objective_name: str) -> EventTimer:
    """An EventTimer in place of the objective's ``get_gradients`` (on its
    class, until ``restore_gradients``)."""
    cls = port_objectives._OBJECTIVES[objective_name]
    timer = EventTimer(cls.get_gradients)
    timer.cls = cls
    cls.get_gradients = lambda obj, score: timer(obj, score)
    return timer


def restore_gradients(timer: EventTimer) -> None:
    timer.cls.get_gradients = timer.fn


class _PlainF64Sums:
    """A callback that sets ``GrowParams.plain_sums`` to "f64" before the
    first iteration (``train`` builds the Booster itself)."""
    before_iteration = True
    order = 0

    def __call__(self, env) -> None:
        impl = env.model._impl
        impl.grow_params = impl.grow_params._replace(plain_sums="f64")


def train_plain_f64(params, ds, valid=None) -> dict:
    """NUM_ITERS iterations of ``params`` on the plain path with float64
    histogram sums (deterministic on the card), with ``valid`` and early
    stopping where given: the Booster, its train metrics and (``valid``)
    its valid ndcg@5 after each iteration. Without ``valid`` it trains as
    ``lgb.train`` does without a valid set (``GBDT.train_many``), so a
    bagged run draws the kernel run's masks."""
    evals = {}
    if valid is None:
        bst = lgb.Booster(params=dict(params, tpu_hist_impl="plain"),
                          train_set=ds)
        bst._impl.grow_params = bst._impl.grow_params._replace(
            plain_sums="f64")
        bst._impl.train_many(NUM_ITERS)
    else:
        bst = lgb.train(dict(params, tpu_hist_impl="plain"), ds,
                        num_boost_round=NUM_ITERS,
                        callbacks=[_PlainF64Sums()], valid_sets=[valid],
                        evals_result=evals,
                        early_stopping_rounds=EARLY_STOPPING_ROUNDS,
                        verbose_eval=False)
    if bst._impl.grow_params.plain_sums != "f64":
        raise AssertionError("the plain run did not sum in float64")
    return {"bst": bst,
            "train": {m: v for _, m, v, _ in bst.eval_train()},
            "valid": evals["valid_0"]["ndcg@5"] if valid else None}


def first_parting(a, b):
    """The first tree at which forests ``a`` and ``b`` differ in structure,
    None where they never do."""
    for i, (ta, tb) in enumerate(zip(a, b)):
        nn = ta.num_leaves_actual - 1
        if tb.num_leaves_actual - 1 != nn or not all(
                np.array_equal(getattr(ta, k)[:nn], getattr(tb, k)[:nn])
                for k in ("split_feature", "threshold_bin", "left_child",
                          "right_child")):
            return i
    return None


def drive_ranking_path(label: str, ds, x, dense: dict, valid=None):
    """Phase 4v-4y and 4zg: lambdarank at full width on the ranking
    workload, with the launch counts set to 0 just before and read just
    after, and the gradient's device time by events; 4v also keeps
    ``valid`` (Dataset, rows), with early stopping, whose device scores must
    be the model's raw predictions, and round-trips its model text; 4zg
    bags whole queries (SAMPLING_PATHS), its draws event-timed and every
    query wholly in or out of each mask. ``dense`` is the dense binary path
    of the same growth mode, for its s/iter."""
    if label in RANKING_PATHS:
        growth = RANKING_PATHS[label]
        params = dict(PARAMS, **RANKING_PARAMS, **GROWTH_PARAMS[growth])
        ref = JAX_RANKING_METRIC[label]
    else:
        growth, extra = SAMPLING_PATHS[label][:2]
        params = dict(PARAMS, **extra, **GROWTH_PARAMS[growth])
        ref = JAX_SAMPLING_METRIC[label]
    kwargs, evals = {}, {}
    if valid is not None:
        kwargs = {"valid_sets": [valid[0]], "evals_result": evals,
                  "early_stopping_rounds": EARLY_STOPPING_ROUNDS,
                  "verbose_eval": False}
    timer = timed_gradients("lambdarank")
    draw = EventTimer(port_gbdt.GBDT._draw_bag_mask)
    masks = []

    def drawn(impl, key):
        draw(impl, key)
        masks.append(impl._bag_mask)
    try:
        with patched((port_gbdt.GBDT, "_draw_bag_mask", drawn)):
            bst, train_s, launches, steps = train_counted(params, ds,
                                                          **kwargs)
    finally:
        restore_gradients(timer)
    trees = len(bst.models)
    grad_bound_ms, _ = lambdarank_bound(np.diff(
        ds._binned.metadata.query_boundaries))
    t0 = time.perf_counter()
    raw_train = bst.predict(x, raw_score=True, num_iteration=NUM_ITERS)
    predict_s = time.perf_counter() - t0
    train = {name: value for _, name, value, _ in bst.eval_train()}
    waves = launches[WAVE_KERNEL[growth]] if growth in WAVE_KERNEL else None
    out = {"growth": growth, "objective": "lambdarank", "train_s": train_s,
           "s_per_iter": train_s / NUM_ITERS, "predict_s": predict_s,
           "x_dense": train_s / NUM_ITERS / dense["s_per_iter"],
           "gradient_ms_per_iter": timer.total_ms() / len(timer.events),
           "gradient_calls": len(timer.events),
           "gradient_bound_ms": grad_bound_ms,
           "train": train, "jax_train": ref["train"],
           "leaves": [t.num_leaves_actual for t in bst.models],
           "waves_per_tree": None if waves is None else waves / trees,
           "launches": launches}
    if "bagging_freq" in params:
        sizes = np.diff(ds._binned.metadata.query_boundaries)
        out["mask_draws"] = len(draw.events)
        out["mask_draw_ms"] = draw.total_ms() / len(draw.events)
        out["in_bag"] = [int(m.sum()) for m in masks]
        log("path %s: %d mask draws of one uniform a query (%d queries), "
            "%.4f ms each; rows in the bag %s" % (
                label, len(masks), len(sizes), out["mask_draw_ms"],
                out["in_bag"]))
        if len(masks) != NUM_ITERS or not queries_whole(masks, sizes):
            raise AssertionError("path %s: %d masks, or a query split by "
                                 "one" % (label, len(masks)))
    log("path %s (%s, lambdarank, %d queries): train %.2f s (%d "
        "iterations, %.3f s per iteration, %.2fx the dense binary path's "
        "%.3f), predict %.3f s, trees %s leaves%s; lambdarank gradient "
        "%.4f ms an iteration on the device (bound %.4f ms)" % (
            label, growth, ds._binned.metadata.num_queries, train_s, trees,
            out["s_per_iter"], out["x_dense"], dense["s_per_iter"],
            predict_s, out["leaves"], "" if waves is None
            else ", %.1f waves per tree" % out["waves_per_tree"],
            out["gradient_ms_per_iter"], grad_bound_ms))
    log("path %s: train %s (JAX package %s); launches %s" % (
        label, " ".join("%s %.6f" % kv for kv in train.items()),
        " ".join("%s %.6f" % kv for kv in ref["train"].items()), launches))
    check_path_launches(label, growth, bst, launches, steps)
    if trees != NUM_ITERS:
        raise AssertionError("path %s: expected %d trees, got %d"
                             % (label, NUM_ITERS, trees))
    if any(n < 2 for n in out["leaves"]):
        raise AssertionError("path %s: a tree did not split (%s)"
                             % (label, out["leaves"]))
    if raw_train.shape != (len(x),) or not np.isfinite(raw_train).all():
        raise AssertionError("path %s: predictions are not finite [n] "
                             "scores" % label)
    if len(timer.events) != NUM_ITERS:
        raise AssertionError("path %s: %d gradient calls in %d iterations"
                             % (label, len(timer.events), NUM_ITERS))
    reset_counts()
    plain = train_plain_f64(params, ds, valid[0] if valid else None)
    if any(read_counts().values()):
        raise AssertionError("path %s: the plain run launched %s"
                             % (label, read_counts()))
    parted = first_parting(bst.models, plain["bst"].models)
    raw_plain = plain["bst"].predict(x, raw_score=True)
    out["plain_f64"] = {"train": plain["train"], "valid": plain["valid"],
                        "parted_at_tree": parted,
                        "max_raw_diff": float(np.abs(raw_train
                                                     - raw_plain).max())}
    log("path %s: the plain path with float64 sums: train %s%s; the kernel "
        "run's trees %s, raw predictions %.3g apart" % (
            label, " ".join("%s %.6f" % (m, plain["train"][m])
                            for m in RANKING_HELD),
            "" if valid is None else ", valid ndcg@5 %s" % plain["valid"],
            "are its trees" if parted is None
            else "part from its trees at tree %d" % parted,
            out["plain_f64"]["max_raw_diff"]))
    if parted == 0:
        # tree 0's gradients are the same in both runs: only an f32 gain
        # tie may part it (tests/test_parity.py's rule)
        trees_match(bst.models[:1], plain["bst"].models[:1])
    elif parted is None and out["plain_f64"]["max_raw_diff"] > F64_RAW_TOL:
        raise AssertionError("path %s: the plain path's trees, but raw "
                             "predictions %.3g apart"
                             % (label, out["plain_f64"]["max_raw_diff"]))
    # where the JAX package's forest parts from the port's plain run at a
    # gain tie (its constant's ``gain_tie``, found on the CPU by
    # scripts/gain_tie_probe.py), neither forest is the other's: both runs
    # are held as a parted kernel run is
    tie = ref.get("gain_tie")
    plain_tol = METRIC_REL_TOL if tie is None else RANK_PARTED_REL_TOL
    kernel_tol = (METRIC_REL_TOL if parted is None and tie is None
                  else RANK_PARTED_REL_TOL)
    if tie is not None:
        log("path %s: the JAX package's trees part from the plain run's at "
            "tree %d, node %d, at a gain tie: its split's exact gain %.6g "
            "(float32 %.6g), the port's %.6g (float32 %.6g)" % (
                label, tie["tree"], tie["node"], tie["jax_exact"],
                tie["jax_f32"], tie["port_exact"], tie["port_f32"]))
    checks = [("plain train " + m, plain["train"][m], ref["train"][m],
               plain_tol) for m in RANKING_HELD]
    checks += [("train " + m, train[m], ref["train"][m], kernel_tol)
               for m in RANKING_HELD]
    if valid is not None:
        xv = valid[1]
        scores = bst._impl.scores_of(1)
        raw = bst.predict(xv, raw_score=True, num_iteration=NUM_ITERS)
        out["valid"] = evals["valid_0"]["ndcg@5"]
        out["jax_valid"] = ref["valid"]
        out["best_iteration"] = bst.best_iteration
        out["valid_score_max_diff"] = float(np.abs(scores - raw).max())
        loaded = lgb.Booster(model_str=bst.model_to_string(
            num_iteration=NUM_ITERS))
        out["model_text_max_diff"] = float(np.abs(
            loaded.predict(x, raw_score=True) - raw_train).max())
        log("path %s: valid ndcg@5 %s (JAX package %s), best iteration %d "
            "(JAX package %d); device valid scores of %d rows against "
            "predict: max diff %.3g; the model text reloaded predicts the "
            "%d rows within %.3g" % (
                label, out["valid"], ref["valid"], bst.best_iteration,
                ref["best_iteration"], len(raw),
                out["valid_score_max_diff"], len(x),
                out["model_text_max_diff"]))
        if out["valid_score_max_diff"] > VALID_SCORE_TOL:
            raise AssertionError("path %s: device valid scores differ from "
                                 "predict by %.3g"
                                 % (label, out["valid_score_max_diff"]))
        if out["model_text_max_diff"] > MODEL_TEXT_TOL:
            raise AssertionError("path %s: the reloaded model text predicts "
                                 "%.3g away" % (label,
                                                out["model_text_max_diff"]))
        if len(out["valid"]) != len(ref["valid"]):
            raise AssertionError("path %s: %d valid evaluations, the JAX "
                                 "package %d" % (label, len(out["valid"]),
                                                 len(ref["valid"])))
        if parted is None and bst.best_iteration != ref["best_iteration"]:
            raise AssertionError("path %s: best iteration %d, the JAX "
                                 "package's %d" % (label, bst.best_iteration,
                                                   ref["best_iteration"]))
        checks += [("plain valid ndcg@5 at iteration %d" % (i + 1), v, r,
                    METRIC_REL_TOL)
                   for i, (v, r) in enumerate(zip(plain["valid"],
                                                  ref["valid"]))]
        checks += [("valid ndcg@5 at iteration %d" % (i + 1), v, r,
                    kernel_tol)
                   for i, (v, r) in enumerate(zip(out["valid"],
                                                  ref["valid"]))]
    gaps = [abs(v - r) / abs(r) for _, v, r, _ in checks]
    out["max_rel_gap"] = max(g for g, c in zip(gaps, checks)
                             if not c[0].startswith("plain"))
    out["gaps"] = {what: gap for (what, _, _, _), gap in zip(checks, gaps)}
    for (what, value, want, tol), gap in zip(checks, gaps):
        if gap > tol:
            raise AssertionError("path %s: %s %.6f is %.3g relative from "
                                 "the JAX package's %.6f (limit %g)"
                                 % (label, what, value, gap, want, tol))
    out.update(iteration_counts(label, bst))
    return out


def drive_xentropy_path(label: str, ds, x, dense: dict):
    """Phase 4z-4za: a cross-entropy objective at full width on
    ``xentropy_data``, with the launch counts set to 0 just before and
    read just after, and the gradient's device time by events. ``dense``
    is the dense binary path of the same growth mode."""
    growth, extra, _ = XENTROPY_PATHS[label]
    objective = extra["objective"]
    params = dict(PARAMS, **extra, **GROWTH_PARAMS[growth])
    ref = JAX_XENTROPY_METRIC[label]
    timer = timed_gradients(objective)
    try:
        bst, train_s, launches, steps = train_counted(params, ds)
    finally:
        restore_gradients(timer)
    trees = len(bst.models)
    train = {name: value for _, name, value, _ in bst.eval_train()}
    held = next(iter(ref))
    out = {"growth": growth, "objective": objective,
           "weighted": ds._binned.metadata.weight is not None,
           "train_s": train_s, "s_per_iter": train_s / NUM_ITERS,
           "x_dense": train_s / NUM_ITERS / dense["s_per_iter"],
           "gradient_ms_per_iter": timer.total_ms() / len(timer.events),
           "train": train, "jax_train": ref,
           "leaves": [t.num_leaves_actual for t in bst.models],
           "launches": launches}
    gap = abs(train[held] - ref[held]) / abs(ref[held])
    out["max_rel_gap"] = gap
    log("path %s (%s, %s%s): train %.2f s (%.3f s per iteration, %.2fx the "
        "dense binary path's %.3f), trees %s leaves, gradient %.4f ms an "
        "iteration; train %s (JAX package %s), %s %.3g relative; launches "
        "%s" % (label, growth, objective, ", weighted" if out["weighted"]
                else "", train_s, out["s_per_iter"], out["x_dense"],
                dense["s_per_iter"], out["leaves"],
                out["gradient_ms_per_iter"],
                " ".join("%s %.6f" % kv for kv in train.items()),
                " ".join("%s %.6f" % kv for kv in ref.items()), held, gap,
                launches))
    check_path_launches(label, growth, bst, launches, steps)
    if trees != NUM_ITERS or any(n < 2 for n in out["leaves"]):
        raise AssertionError("path %s: expected %d trees that split, got %s"
                             % (label, NUM_ITERS, out["leaves"]))
    pred = bst.predict(x)
    if pred.shape != (len(x),) or not np.isfinite(pred).all() or (
            pred.min() < 0 or (objective == "xentropy" and pred.max() > 1)):
        raise AssertionError("path %s: predictions are not finite [n] "
                             "values of the objective's link" % label)
    if gap > METRIC_REL_TOL:
        raise AssertionError("path %s: train %s %.6f is %.3g relative from "
                             "the JAX package's %.6f"
                             % (label, held, train[held], gap, ref[held]))
    out.update(iteration_counts(label, bst))
    return out


# path 4zy (ROADMAP Queue 1 #11): 4b's data and parameters streamed from a
# .npy memory map in chunks of STREAM_CHUNK_ROWS rows (8 chunks), round 1's
# sample the whole data; streamed auto packs the chunks into int32 words
# (byte). The in-memory loader samples bin_construct_sample_cnt rows at
# random (200,000 of 4b's 1,000,000) where the stream keeps a reservoir,
# so the two give the same mappers only when both sample every row: 4zy is
# held to an in-memory frontier run with bin_construct_sample_cnt = N.
# Phase 5's streamed row: COMPARE_ROWS rows in chunks of
# STREAM_COMPARE_CHUNK_ROWS
STREAM_CHUNK_ROWS = 131_072
STREAM_COMPARE_CHUNK_ROWS = COMPARE_ROWS // 4
# 4b's booster, saved by the main process for the compare part's 4zz: its
# trees, next to the parts' directories
FRONTIER_REF = "frontier_ref.pkl"
STREAM_PREDICT_TOL = 1e-5     # predict against the training scores (raw)


def save_frontier_ref(bst, tmp: str) -> None:
    with open(os.path.join(tmp, FRONTIER_REF), "wb") as f:
        pickle.dump(bst.models, f)


def load_frontier_ref(tmp: str) -> list:
    with open(os.path.join(os.path.dirname(tmp), FRONTIER_REF), "rb") as f:
        return pickle.load(f)


def word_launches(label: str, launches: dict, rounds: int) -> None:
    """Raises unless a path on packed words launched the word variants
    only: histogram.cu's at every root (once a chunk when streamed) and
    hist_slots.cu's on its waves."""
    if launches["build_histogram_words_cuda"] < rounds \
            or launches["build_histogram_slots_words_cuda"] <= 0:
        raise AssertionError("path %s launched the word kernels %s"
                             % (label, launches))
    uint8 = {k: v for k, v in launches.items() if v and "words" not in k}
    if uint8:
        raise AssertionError("path %s on packed words launched %s"
                             % (label, uint8))


def held_to(label: str, bst, ref_models: list, what: str,
            rows: torch.Tensor, auc_now, auc_ref,
            regrow_gain_rel: float = None) -> list:
    """``bst``'s trees against ``ref_models`` (``what``'s) under phase 5's
    frontier rule (WAVE_PARTING, with ``trees_match``'s
    ``regrow_gain_rel``); where they part at a tie, the two AUCs within
    AUC_TOLERANCE. Returns the ties."""
    ties = []
    trees_match(bst.models, ref_models, ties, WAVE_PARTING, regrow_gain_rel,
                rows)
    if any(t["after_parting_tie"] for t in ties) \
            and abs(auc_now - auc_ref) > AUC_TOLERANCE:
        raise AssertionError("path %s parted from %s at a tie and its AUC "
                             "%.6f is more than %g from %.6f"
                             % (label, what, auc_now, AUC_TOLERANCE,
                                auc_ref))
    return ties


def drive_stream_path(x, y, dense: dict, tmp: str) -> dict:
    """Path 4zy: 4b's 1,000,000 rows streamed from a .npy memory map
    (``data_stream_chunk_rows=STREAM_CHUNK_ROWS``, 8 chunks), 5 iterations,
    round 1 sampling every row: its mappers and stored layout equal to the
    in-memory loader's at the same ``bin_construct_sample_cnt``, its trees
    that in-memory frontier run's under the frontier tie rule, its train
    AUC within AUC_TOLERANCE of the JAX package's 4b constant, ``predict``
    equal to the training scores within STREAM_PREDICT_TOL, and the word
    variants of both kernels launched (and no uint8 one); prints its
    s/iter beside 4b's and the in-memory run's, the pipeline's overlap and
    ingest rate, and one more iteration's launches and syncs."""
    memory = dict(PARAMS, **GROWTH_PARAMS["frontier"],
                  bin_construct_sample_cnt=len(x))
    t0 = time.perf_counter()
    mem_ds = lgb.Dataset(x, label=y, params=memory).construct()
    mem_binning_s = time.perf_counter() - t0
    mem, mem_s, _, _ = train_counted(memory, mem_ds)
    mem_auc = auc(mem.predict(x, raw_score=True), y)
    path = os.path.join(tmp, "dense.npy")
    np.save(path, x)
    params = dict(memory, data_stream_chunk_rows=STREAM_CHUNK_ROWS)
    t0 = time.perf_counter()
    ds = lgb.Dataset(path, label=y, params=params).construct()
    ingest_s = time.perf_counter() - t0
    sd = ds._binned
    if [m.to_dict() for m in sd.bin_mappers] != [
            m.to_dict() for m in mem_ds._binned.bin_mappers] \
            or sd.col_features != mem_ds._binned.col_features:
        raise AssertionError("4zy: the streamed mappers are not the "
                             "in-memory loader's")
    del mem_ds
    bst, train_s, launches, _ = train_counted(params, ds)
    impl = bst._impl
    pipe = impl._stream
    stats = pipe.stats()
    raw = bst.predict(x, raw_score=True)
    predict_diff = float(np.abs(raw - impl.scores_of(0)).max())
    train_auc = auc(raw, y)
    log("path 4zy streamed: ingest %.2f s (in memory: binning %.2f s; %d "
        "chunks of %d rows, %d stored columns as %d words a row), train "
        "%.2f s (%.3f s per iteration, in memory %.3f, 4b %.3f), "
        "overlap_efficiency %.4f, ingest %.4g rows/s (wait %.4f s of %.4f "
        "s of sweeps), train AUC %.6f (in memory %.6f, 4b %.6f, JAX "
        "package %.6f), predict against the training scores %.3g, "
        "launches %s"
        % (ingest_s, mem_binning_s, pipe.num_chunks, pipe.chunk_rows,
           pipe.num_cols, binpack.words_per_row(pipe.num_cols), train_s,
           train_s / len(bst.models), mem_s / len(mem.models),
           dense["frontier"]["s_per_iter"], stats["overlap_efficiency"],
           stats["ingest_rows_per_sec"], stats["wait_s"], stats["total_s"],
           train_auc, mem_auc, dense["frontier"]["auc"],
           JAX_REFERENCE_AUC["frontier"], predict_diff, launches))
    if pipe.num_chunks != -(-len(x) // STREAM_CHUNK_ROWS) or not pipe.packed:
        raise AssertionError("4zy: %d chunks, packed %s" % (pipe.num_chunks,
                                                           pipe.packed))
    word_launches("4zy", launches, NUM_ITERS * pipe.num_chunks)
    if predict_diff > STREAM_PREDICT_TOL or not np.isfinite(raw).all():
        raise AssertionError("4zy: predict is %.3g from the training scores"
                             % predict_diff)
    if abs(train_auc - JAX_REFERENCE_AUC["frontier"]) > AUC_TOLERANCE:
        raise AssertionError("4zy: train AUC %.6f is more than %g from the "
                             "JAX package's %.6f" % (
                                 train_auc, AUC_TOLERANCE,
                                 JAX_REFERENCE_AUC["frontier"]))
    rows = torch.as_tensor(x, dtype=torch.float64, device="cuda")
    ties = held_to("4zy", bst, mem.models, "the in-memory run", rows,
                   train_auc, mem_auc)
    out = {"ingest_s": ingest_s, "memory_binning_s": mem_binning_s,
           "memory_s_per_iter": mem_s / len(mem.models),
           "memory_auc": mem_auc, "train_s": train_s,
           "s_per_iter": train_s / len(bst.models),
           "x_frontier": train_s / len(bst.models)
           / dense["frontier"]["s_per_iter"],
           "auc": train_auc, "predict_diff": predict_diff,
           "pipeline": stats, "ties": ties, "launches": launches}
    out.update(iteration_counts("4zy", bst))
    return out


def drive_packed_paths(x, y, dense: dict, ref_models: list) -> dict:
    """Path 4zz: packed bin words in memory (frontier). ``byte`` on 4b's
    data, its trees 4b's under the frontier tie rule; ``nibble`` on
    ``small_bin_data`` (1,000,000 x NIBBLE_FEATURES), its stored columns at
    most half the features and fewer than its ``none`` run's, its trees the
    ``none`` run's under the same rule and its AUC within AUC_TOLERANCE of
    it. Each launches the word variants only."""
    out = {}
    params = dict(PARAMS, **GROWTH_PARAMS["frontier"])
    ds = lgb.Dataset(x, label=y, params=params).construct()
    bst, train_s, launches, _ = train_counted(
        dict(params, tpu_bin_packing="byte"), ds)
    raw = bst.predict(x, raw_score=True)
    train_auc = auc(raw, y)
    log("path 4zz byte: train %.2f s (%.3f s per iteration, 4b %.3f), "
        "train AUC %.6f (4b %.6f), launches %s"
        % (train_s, train_s / len(bst.models),
           dense["frontier"]["s_per_iter"], train_auc,
           dense["frontier"]["auc"], launches))
    word_launches("4zz byte", launches, NUM_ITERS)
    rows = torch.as_tensor(x, dtype=torch.float64, device="cuda")
    out["4zz byte"] = {
        "train_s": train_s, "s_per_iter": train_s / len(bst.models),
        "auc": train_auc, "launches": launches,
        "ties": held_to("4zz byte", bst, ref_models, "4b", rows, train_auc,
                        dense["frontier"]["auc"])}
    del ds, bst, rows
    xn, yn = small_bin_data(MAIN_ROWS)
    runs = {}
    for mode in ("none", "nibble"):
        p = dict(params, tpu_bin_packing=mode)
        t0 = time.perf_counter()
        dsn = lgb.Dataset(xn, label=yn, params=p).construct()
        binning_s = time.perf_counter() - t0
        bst, train_s, launches, _ = train_counted(p, dsn)
        runs[mode] = {"bst": bst, "columns": dsn._binned.num_columns,
                      "max_col_bins": dsn._binned.max_col_bins(),
                      "binning_s": binning_s, "train_s": train_s,
                      "launches": launches,
                      "auc": auc(bst.predict(xn, raw_score=True), yn)}
        log("path 4zz %s: %d stored columns (widest %d bins), binning "
            "%.2f s, train %.2f s (%.3f s per iteration), train AUC %.6f, "
            "launches %s" % (mode, runs[mode]["columns"],
                             runs[mode]["max_col_bins"], binning_s, train_s,
                             train_s / len(bst.models), runs[mode]["auc"],
                             launches))
        del dsn
    none, nib = runs["none"], runs["nibble"]
    word_launches("4zz nibble", nib["launches"], NUM_ITERS)
    if not nib["columns"] <= NIBBLE_FEATURES // 2 < none["columns"]:
        raise AssertionError("4zz nibble: %d stored columns against none's "
                             "%d" % (nib["columns"], none["columns"]))
    if abs(nib["auc"] - none["auc"]) > AUC_TOLERANCE:
        raise AssertionError("4zz nibble: train AUC %.6f is more than %g "
                             "from none's %.6f" % (nib["auc"],
                                                   AUC_TOLERANCE,
                                                   none["auc"]))
    ties = []
    trees_match(nib["bst"].models, none["bst"].models, ties, WAVE_PARTING,
                None, torch.as_tensor(xn, dtype=torch.float64,
                                      device="cuda"))
    for mode, run_ in runs.items():
        bst = run_.pop("bst")
        out["4zz %s" % mode] = dict(run_, s_per_iter=run_["train_s"]
                                    / len(bst.models),
                                    ties=ties if mode == "nibble" else None)
    return out


def drive_ranking_workloads(paths: dict, dev) -> dict:
    """Phase 4v-4za: the ranking paths on ``ranking_data`` (a valid set
    with its own groups for 4v), the cross-entropy paths on
    ``xentropy_data``, each beside the dense binary path of its growth mode
    in ``paths``, then the lambdarank gradient at MSLR-WEB30K's shape.
    Adds the paths to ``paths``; returns the scale check's numbers."""
    x_rank, rel, sizes = ranking_data(RANKING_ROWS)
    xv, relv, sizes_v = ranking_data(RANKING_VALID_ROWS, seed=1)
    t0 = time.perf_counter()
    ds = lgb.Dataset(x_rank, label=rel, group=sizes,
                     params=PARAMS).construct()
    binning_s = time.perf_counter() - t0
    valid = ds.create_valid(xv, label=relv, group=sizes_v).construct()
    log("binning: %.2f s for %d x %d in %d queries (labels 0-4: %s), the "
        "valid set's %d rows in %d queries %.2f s more"
        % (binning_s, *x_rank.shape, len(sizes),
           np.bincount(rel.astype(np.int64)).tolist(), len(xv),
           len(sizes_v), time.perf_counter() - t0 - binning_s))
    for label, growth in RANKING_PATHS.items():
        paths[label] = drive_ranking_path(
            label, ds, x_rank, paths[growth],
            (valid, xv) if label == "4v" else None)
        paths[label]["binning_s"] = binning_s
    # 4zg: bagging of whole queries on the same binned data
    paths["4zg"] = drive_ranking_path("4zg", ds, x_rank,
                                      paths[SAMPLING_PATHS["4zg"][0]])
    paths["4zg"]["binning_s"] = binning_s
    # 4zp: float64 histograms on the same binned data
    paths["4zp"] = drive_f64_path("4zp", ds, x_rank, None, paths["4v"])
    paths["4zp"]["binning_s"] = binning_s
    del ds, valid
    x_xe, y_xe, w_xe = xentropy_data(MAIN_ROWS)
    for label, (growth, _, weighted) in XENTROPY_PATHS.items():
        t0 = time.perf_counter()
        ds = lgb.Dataset(x_xe, label=y_xe, weight=w_xe if weighted else None,
                         params=PARAMS).construct()
        binning_s = time.perf_counter() - t0
        log("binning: %.2f s for %d x %d" % (binning_s, *x_xe.shape))
        paths[label] = drive_xentropy_path(label, ds, x_xe, paths[growth])
        paths[label]["binning_s"] = binning_s
        del ds
    for label in list(RANKING_PATHS) + ["4zg"] + list(XENTROPY_PATHS):
        m = paths[label]
        d = paths[m["growth"]]
        log("path %s against %s (the same growth, dense binary): %.3f "
            "against %.3f s per iteration (%.2fx), %d against %d launches "
            "and %d against %d syncs an iteration, gradient %.4f ms an "
            "iteration, binning %.2f s" % (
                label, m["growth"], m["s_per_iter"], d["s_per_iter"],
                m["x_dense"], m["launches_per_iter"],
                d["launches_per_iter"], m["syncs_per_iter"],
                d["syncs_per_iter"], m["gradient_ms_per_iter"],
                m["binning_s"]))
    return check_lambdarank_at_scale(dev)


# phase 5: (label, parameters over PARAMS, the wrapper the kernel run must
# launch)
COMPARE_RUNS = [
    ("exact", GROWTH_PARAMS["exact"], "build_histogram_cuda"),
    ("frontier", GROWTH_PARAMS["frontier"], "build_histogram_slots_cuda"),
    ("batched", GROWTH_PARAMS["batched"], "build_histogram_slots6_cuda"),
    ("batched_pack", dict(GROWTH_PARAMS["batched"], tpu_batched_pack=True),
     "build_histogram_slots_cuda"),
    ("batched_part", GROWTH_PARAMS["batched_part"],
     "build_histogram_part_tiles_cuda"),
]


def train_compared(params, ds, sums: str):
    """COMPARE_ITERS iterations of a Booster on ``ds``, the plain
    histograms summed as ``sums`` says (``GrowParams.plain_sums``: one
    running f32 sum per cell, as ``index_add_`` keeps it, drifts on bins
    of many rows, where the kernels, "blocked" and "f64" sums agree)."""
    bst = lgb.Booster(params=params, train_set=ds)
    impl = bst._impl
    impl.grow_params = impl.grow_params._replace(plain_sums=sums)
    for _ in range(COMPARE_ITERS):
        bst.update()
    return bst


# phase 5 on sampled rows (bench.py's data, COMPARE_ROWS): a bagging mask
# with zeros in the count channel, and GOSS's amplified gradients after its
# one-iteration warm-up, each through every grower of COMPARE_RUNS against
# the float64 plain path
SAMPLED_COMPARE = {
    "bagged": {"bagging_fraction": 0.5, "bagging_freq": 1},
    "GOSS": {"boosting": "goss", "learning_rate": 1.0},
}
def constraint_compare_runs(directory: str) -> list:
    """Phase 5's constraint rows on bench.py's data: each grower of
    COMPARE_RUNS but batched_pack under MONOTONE_CONSTRAINTS, and exact
    growth with forced splits and CEGB, whose kernel run must launch the
    hist_for_leaf route."""
    runs = [("%s, monotone" % label,
             dict(extra, monotone_constraints=MONOTONE_CONSTRAINTS), wrapper)
            for label, extra, wrapper in COMPARE_RUNS
            if label != "batched_pack"]
    runs.append(("exact, forced splits and CEGB",
                 dict(GROWTH_PARAMS["exact"],
                      **constraint_params("forced", directory),
                      **constraint_params("cegb", directory)),
                 "build_histogram_leaf_cuda"))
    return runs


# phase 5's plain paths, by whether their histograms sum in float64: f32
# sums are blocked (core/histogram.py plain sums "blocked": each cell's
# rows in runs of BLOCK_ROWS rows landing in that cell, the runs' sums
# added in order; not the JAX matmul's blocks of BLOCK_ROWS consecutive
# rows), since one running f32 sum a cell drifts on bundled data by 1.6e-5
# to 4.0e-5 of the root's gain, as far as a small fault moves it
PLAIN_PATHS = {False: "plain_blocked", True: "plain_f64"}


def compare_paths(ds, xs, ys, raw_tol: float = 1e-5, runs=COMPARE_RUNS,
                  plains=(False, True)):
    """Phase 5: for each growth mode of ``runs``, the kernel path against
    the plain path with float64 histogram sums (no drift) and, on the data
    phase 5 has held the kernels to from the start, against the f32 plain
    path too (blocked sums, ``PLAIN_PATHS``; ``plains`` says which). Trees
    equal up to f32 gain ties (``trees_match``) against each; where they are
    identical, raw predictions within ``raw_tol`` of the f32 plain path's
    and within F64_RAW_TOL (scaled by the run's learning rate over
    F64_RAW_TOL_LR where it is larger) of the float64 path's; where they
    part at a tie of one leaf's candidates (``tie_limits``), or on bagged
    or GOSS rows grow on other scores after an f32 gain tie, the two
    forests' AUC on ``xs`` within AUC_TOLERANCE of each other."""
    categorical = bool(ds._binned is not None and any(
        m.bin_type == BinType.CATEGORICAL for m in ds._binned.bin_mappers))
    out = {}
    rows = torch.as_tensor(xs, dtype=torch.float64, device="cuda")
    for label, extra, wrapper in runs:
        parting, regrow_gain_rel = tie_limits(extra, categorical)
        forests = {}
        for name, impl, f64 in (("kernel", "auto", False),) + tuple(
                (PLAIN_PATHS[f64], "plain", f64) for f64 in plains):
            reset_counts()
            forests[name] = train_compared(
                dict(PARAMS, tpu_hist_impl=impl, **extra), ds,
                "f64" if f64 else "blocked")
            counts = read_counts()
            if (counts[wrapper] > 0) != (impl == "auto"):
                raise AssertionError("%s %s path: %s launched %d times"
                                     % (label, name, wrapper,
                                        counts[wrapper]))
            if impl == "auto":
                launches = counts[wrapper]
        raw = {name: f.predict(xs, raw_score=True)
               for name, f in forests.items()}
        aucs = ({name: auc(r, ys) for name, r in raw.items()}
                if parting or regrow_gain_rel else None)
        out[label] = {"launches": launches, "auc": aucs}
        for f64 in plains:
            rate = extra.get("learning_rate", F64_RAW_TOL_LR)
            name, tol = PLAIN_PATHS[f64], (
                F64_RAW_TOL * max(1.0, rate / F64_RAW_TOL_LR) if f64
                else raw_tol)
            ties = []
            identical = trees_match(forests["kernel"].models,
                                    forests[name].models, ties,
                                    parting, regrow_gain_rel, rows)
            raw_diff = float(np.abs(raw["kernel"] - raw[name]).max())
            parted = any(t["after_parting_tie"] for t in ties)
            log("kernel vs %s path, %s: trees %s, max raw prediction diff "
                "%.3g%s, %s launches %d" % (
                    name, label, "identical" if identical
                    else "parted at a tie" if parted
                    else "equal up to f32 gain ties", raw_diff,
                    ", AUC %.6f against %.6f" % (aucs["kernel"], aucs[name])
                    if aucs else "", wrapper, launches))
            if identical and raw_diff > tol:
                raise AssertionError("%s: identical trees but raw "
                                     "predictions differ from the %s path's "
                                     "by %.3g" % (label, name, raw_diff))
            if parted and abs(aucs["kernel"] - aucs[name]) > AUC_TOLERANCE:
                raise AssertionError("%s: after a tie the kernel and %s "
                                     "paths' AUC differ by more than %g"
                                     % (label, name, AUC_TOLERANCE))
            out[label][name] = {"identical": identical,
                                "max_raw_diff": raw_diff, "ties": ties}
    return out


# phase 5's float64 rows (gpu_use_dp, exact growth) on COMPARE_ROWS of the
# dense and the bundled data: the f64 kernel path twice and the f64 plain
# path, trees identical node for node with no tie rule, raw predictions
# within F64_COMPARE_RAW_TOL. The kernels' f64 atomics add in another order
# each run, but round at 2^-53: no gain tie of f32 sums is left, and each
# leaf value is rounded to f32 once
F64_COMPARE_RAW_TOL = 1e-6
STRICT_FIELDS = ("split_feature", "threshold_bin", "default_left",
                 "left_child", "right_child", "split_leaf",
                 "cat_bitset_bin")


def first_difference(a, b):
    """(tree, node) where forests ``a`` and ``b`` first differ node for node
    (STRICT_FIELDS, and the trees' sizes), None where they never do."""
    for i, (ta, tb) in enumerate(zip(a, b)):
        nn = min(ta.num_leaves_actual, tb.num_leaves_actual) - 1
        for j in range(nn):
            if not all(np.array_equal(getattr(ta, k)[j], getattr(tb, k)[j])
                       for k in STRICT_FIELDS):
                return i, j
        if ta.num_leaves_actual != tb.num_leaves_actual:
            return i, nn
    return None


def compare_f64(ds, xs, data: str, extra: Optional[dict] = None,
                wrappers=("build_histogram_f64_cuda",)) -> dict:
    """Phase 5's f64 rows on ``ds`` (rows ``xs``): the f64 kernel path,
    again, and the f64 plain path, COMPARE_ITERS iterations each with the
    launch counts set to 0 just before and read just after, ``extra`` over
    the parameters (forced splits with CEGB, whose kernel runs must launch
    the f64 ``hist_for_leaf`` route too: ``wrappers``). Raises unless
    every pair's trees are identical node for node (where they are not,
    it logs the first node that differs: both splits' gains, leaves and
    rows) and their raw predictions within F64_COMPARE_RAW_TOL."""
    params = dict(PARAMS, gpu_use_dp=True, **GROWTH_PARAMS["exact"],
                  **(extra or {}))
    forests, launches = {}, {}
    for name, impl in (("kernel", "auto"), ("kernel again", "auto"),
                       ("plain_f64", "plain")):
        reset_counts()
        forests[name] = train_compared(dict(params, tpu_hist_impl=impl), ds,
                                       "running")
        counts = read_counts()
        n64 = sum(counts[w] for w in wrappers)
        if any((counts[w] > 0) != (impl == "auto") for w in wrappers) \
                or sum(counts.values()) != n64:
            raise AssertionError("f64 %s path on the %s data launched %s"
                                 % (name, data, counts))
        launches[name] = {w: counts[w] for w in wrappers}
    raw = {name: f.predict(xs, raw_score=True) for name, f in forests.items()}
    out = {"launches": launches["kernel"]}
    kernel_launches = ", ".join("%s launches %d" % kv
                                for kv in launches["kernel"].items())
    for other in ("kernel again", "plain_f64"):
        at = first_difference(forests["kernel"].models, forests[other].models)
        raw_diff = float(np.abs(raw["kernel"] - raw[other]).max())
        if at is not None:
            i, j = at
            ta, tb = forests["kernel"].models[i], forests[other].models[i]
            log("f64 kernel vs %s path on the %s data: tree %d parts at "
                "node %d: (leaf, feature, bin, gain, rows) %s against %s"
                % (other, data, i, j, *[
                    (int(t.split_leaf[j]), int(t.split_feature[j]),
                     int(t.threshold_bin[j]), float(t.split_gain[j]),
                     int(t.internal_count[j])) if j < t.num_leaves_actual - 1
                    else None for t in (ta, tb)]))
            raise AssertionError("f64 kernel and %s trees differ on the %s "
                                 "data (no tie rule holds f64 rows)"
                                 % (other, data))
        log("f64 kernel vs %s path on the %s data (%d rows, exact): trees "
            "identical node for node, max raw prediction diff %.3g, %s"
            % (other, data, len(xs), raw_diff, kernel_launches))
        if raw_diff > F64_COMPARE_RAW_TOL:
            raise AssertionError("f64 %s: identical trees but raw predictions "
                                 "%.3g apart" % (other, raw_diff))
        out[other] = {"identical": True, "max_raw_diff": raw_diff}
    return out


def tie_limits(extra: dict, categorical: bool) -> tuple:
    """A phase 5 row's exemptions from the tie rule (``trees_match``): the
    parting tie's gain limit on data with categorical features or under
    monotone constraints, and the regrowth's gain-sum limit on sampled
    rows or under monotone constraints; (None, None) for forced splits
    with CEGB, whose trees came out identical in every H100 run (bagged as
    they are), held to the rule and F64_RAW_TOL alone."""
    if "forcedsplits_filename" in extra:
        return None, None
    monotone = "monotone_constraints" in extra
    parting = (CAT_PARTING if categorical else CLAMP_PARTING
               if monotone else WAVE_PARTING
               if extra.get("tree_growth") == "frontier" else None)
    regrow = (monotone or extra.get("boosting") == "goss"
              or extra.get("bagging_freq", 0) > 0)
    return parting, SAMPLED_TIE_GAIN_REL if regrow else None


def node_rows(t, nn: int, x: torch.Tensor) -> tuple:
    """Fingerprints of the training rows ``x`` [N, F] (float64, on any
    device) that each of the tree's first ``nn`` nodes splits and that it
    sends right: sums of one random 40-bit weight a row (seed 0), exact in
    int64, so two nodes holding the same rows have the same print and two
    holding different rows collide with odds of about 2^-40. The rows are
    replayed through the splits in split order, as ``predict`` does."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    weight = torch.randint(0, 1 << 40, (x.shape[0],), generator=gen,
                           dtype=torch.int64).to(x.device)
    leaf_id = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    split, right = torch.zeros(2, nn, dtype=torch.int64, device=x.device)
    for i in range(nn):
        fval = x[:, int(t.split_feature[i])]
        if t.is_categorical[i]:
            go_left = tree_mod.categorical_go_left(fval, torch.as_tensor(
                t.cat_bitset[i].view(np.int32), device=x.device))
        else:
            go_left = tree_mod.decision_go_left(
                fval, float(t.threshold[i]),
                torch.tensor(bool(t.default_left[i]), device=x.device),
                torch.tensor(int(t.missing_type[i]), device=x.device))
        in_leaf = leaf_id == int(t.split_leaf[i])
        move = in_leaf & ~go_left
        split[i] = torch.where(in_leaf, weight, 0).sum()
        right[i] = torch.where(move, weight, 0).sum()
        leaf_id = torch.where(move, i + 1, leaf_id)
    return split.cpu().numpy(), right.cpu().numpy()


def parting_tie(ta, tb, x: torch.Tensor, limits: PartingLimits):
    """Where two trees first part at a tie, matching nodes by the training
    rows ``x`` they split (``node_rows``), so that two leaves split in
    another order do not count as a parting. A tree's first split (in its
    own order) that the other tree does not make, on the same rows with
    the same feature and threshold, is a tie if it is a choice between
    candidates for one leaf: the other tree splits the same rows there,
    into the same two sets ("alike") or others ("differently"), with a
    gain within ``limits``; or a null split (gain within ``limits.root_rel``
    of 0, relative to the root's: a leaf split on rounding in one run only,
    after which a frontier wave splits one leaf fewer or more elsewhere;
    under monotone constraints a leaf whose children both clamp to its own
    bound makes one, and frontier, which splits every leaf of positive
    gain, takes them). With ``limits.root_rel`` the splits it made
    before, which the other tree made too, must also have gains within it
    of the other's. One of the two trees' first such splits must be a tie,
    as the other's may follow from it. Returns None where neither is, else
    (node, kind, the two gains' difference relative to the other's gain,
    and relative to the root's, the largest such difference relative to
    the root's of the splits before it); where the trees make the same
    splits in another order, (0, "order", 0, 0, the largest difference of
    their gains relative to the root's)."""
    nodes = []
    for t in (ta, tb):
        nn = int(t.num_leaves_actual) - 1
        split, right = node_rows(t, nn, x)
        keys = [(int(split[i]), int(right[i]), int(t.split_feature[i]),
                 int(t.threshold_bin[i]), t.cat_bitset_bin[i].tobytes())
                for i in range(nn)]
        nodes.append((t, split, right, {k: i for i, k in enumerate(keys)},
                      keys))
    null_rel = (limits.null_rel if limits.null_rel is not None
                else -np.inf if limits.root_rel is None else limits.root_rel)
    firsts, order = [], None
    for (t, split, right, _, keys), (o, o_split, o_right, o_index, _) in (
            (nodes[0], nodes[1]), (nodes[1], nodes[0])):
        root = max(abs(float(t.split_gain[0])), 1e-30)
        shared, tie = 0.0, None
        for i, key in enumerate(keys):
            j = o_index.get(key)
            if j is not None:
                shared = max(shared, abs(float(t.split_gain[i]
                                               - o.split_gain[j])) / root)
                continue
            j = np.flatnonzero(o_split == split[i])
            if t.split_gain[i] / root <= null_rel:
                tie = (i, "null", 0.0, float(t.split_gain[i] / root), shared)
            elif len(j):
                diff = abs(float(t.split_gain[i] - o.split_gain[j[0]]))
                tie = (i, "alike" if right[i] in (
                    o_right[j[0]], split[i] - o_right[j[0]])
                    else "differently",
                    diff / max(abs(float(o.split_gain[j[0]])), 1e-30),
                    diff / root, shared)
            else:
                tie = (i, None)
            break
        if tie is None:
            order = max(order or 0.0, shared)
        else:
            firsts.append(tie)
    if not firsts:
        firsts = [(0, "order", 0.0, 0.0, order)]
    found = [tie for tie in firsts if tie[1] is not None
             and (limits.gain_rel is None or tie[2] <= limits.gain_rel)
             and (limits.root_rel is None
                  or max(tie[3], tie[4]) <= limits.root_rel)]
    return min(found, key=lambda tie: max(tie[3], tie[4]), default=None)


def node_waves(t, nn: int) -> np.ndarray:
    """[nn] the wave of each of the tree's first ``nn`` nodes under
    frontier growth: its depth. A wave splits every leaf of positive gain
    until the leaf cap binds, which ends the tree, so wave w splits the
    leaves of depth w and only the last wave leaves some of them whole."""
    depth = np.zeros(nn, np.int64)
    for i in range(nn):
        for c in (int(t.left_child[i]), int(t.right_child[i])):
            if 0 <= c < nn:
                depth[c] = depth[i] + 1
    return depth


def substituted_splits(ta, tb, x: torch.Tensor) -> list:
    """The splits each tree makes that the other does not make on the same
    training rows ``x`` with the same feature and bin (nodes matched by
    ``node_rows``, in any order): for each, the tree ("a" or "b"), node,
    wave (``node_waves``), leaf split, rows (its training count), feature,
    bin and gain."""
    keys = []
    for t in (ta, tb):
        nn = int(t.num_leaves_actual) - 1
        split, right = node_rows(t, nn, x)
        keys.append([(int(split[i]), int(right[i]), int(t.split_feature[i]),
                      int(t.threshold_bin[i]), t.cat_bitset_bin[i].tobytes())
                     for i in range(nn)])
    out = []
    for name, t, mine, other in (("a", ta, keys[0], keys[1]),
                                 ("b", tb, keys[1], keys[0])):
        waves = node_waves(t, len(mine))
        left = collections.Counter(other)
        for i, key in enumerate(mine):
            if left[key] > 0:
                left[key] -= 1
                continue
            out.append({"tree": name, "node": i, "wave": int(waves[i]),
                        "leaf": int(t.split_leaf[i]),
                        "rows": int(t.internal_count[i]),
                        "feature": int(t.split_feature[i]),
                        "bin": int(t.threshold_bin[i]),
                        "gain": float(t.split_gain[i])})
    return out


def trees_match(a, b, ties=None, parting: PartingLimits = None,
                regrow_gain_rel: float = None, x: torch.Tensor = None
                ) -> bool:
    """True when the forests are structurally identical. Otherwise they
    must satisfy the tie rule of tests/test_parity.py, or this raises.

    With ``parting`` (a row whose trees may part at a tie of one leaf's
    candidates) a tree that breaks the positional rule may instead part at
    such a tie: the trees make the same splits, on the same training rows
    ``x`` (in any order), up to a split where both split the same rows
    otherwise, or where one makes a null split, with gains within
    ``parting`` (``parting_tie``). On data with categorical features
    (CAT_PARTING) the categorical finder turns f32 rounding of a leaf's
    totals into gain shifts of that size: a one-vs-rest split of a leaf
    holding two categories and its mirror, or two sorted subsets, trade
    places with the summation order. Under monotone constraints
    (CLAMP_PARTING) a bound that binds clamps a leaf's candidates to the
    same outputs, so their gains tie. The tree regrows from there
    (``scripts/summation_order_probe.py``), and from such a tie on the
    caller holds the two forests to their AUC (``compare_paths``).

    With ``regrow_gain_rel`` (rows whose ties move the trees after them) a
    tree may also break the count of substituted splits where its gain sum
    is within this of the other's, and the trees after one that differs
    grow on other scores, and part there. On bagged or GOSS rows: under
    GOSS on another sample, since GOSS keeps the rows whose |g h| reaches
    its threshold and a leaf's rows share g and h, so a leaf value moved by
    a tie takes its rows across the threshold together. Under monotone
    constraints: a substituted split moves leaf values, and the next
    tree's clamped candidates tie again. From there on the caller holds
    the two forests to their AUC as after a parting tie. ``ties`` (a
    list), where given, records each tie."""
    identical, parted = True, False
    for ta, tb in zip(a, b):
        nn = ta.num_leaves_actual - 1
        sized = tb.num_leaves_actual - 1 == nn
        if sized and all(np.array_equal(getattr(ta, k)[:nn],
                                        getattr(tb, k)[:nn])
                         for k in ("split_feature", "threshold_bin",
                                   "left_child", "right_child",
                                   "cat_bitset_bin")):
            continue
        identical = False
        if not sized and parting is None:
            raise AssertionError("kernel and plain trees differ in size")
        nn = min(nn, tb.num_leaves_actual - 1)
        mism = np.flatnonzero(ta.split_feature[:nn] != tb.split_feature[:nn])
        ca = collections.Counter(zip(ta.split_feature[:nn].tolist(),
                                     np.round(ta.threshold[:nn], 9)))
        cb = collections.Counter(zip(tb.split_feature[:nn].tolist(),
                                     np.round(tb.threshold[:nn], 9)))
        sym = sum(((ca - cb) + (cb - ca)).values())
        gain_rel = abs(ta.split_gain[:nn].sum() - tb.split_gain[:nn].sum()) \
            / max(abs(tb.split_gain[:nn].sum()), 1e-30)
        within_rule = (sized and len(mism) <= 6 and sym <= 4
                       and gain_rel <= 1e-3)
        if regrow_gain_rel is not None and sized and not within_rule \
                and len(mism) <= 6 and gain_rel <= regrow_gain_rel:
            # a tie of frontier's last wave: the AUC holds from here
            within_rule = parted = True
        tie = None
        if parting is WAVE_PARTING:
            # a frontier row's substituted splits, both trees'
            for sub in substituted_splits(ta, tb, x):
                log("  substituted split of the %s tree: node %d, wave %d, "
                    "leaf %d, %d rows, feature %d, bin %d, gain %.7g"
                    % (("kernel", "other")[sub["tree"] == "b"],
                       sub["node"], sub["wave"], sub["leaf"], sub["rows"],
                       sub["feature"], sub["bin"], sub["gain"]))
        if parting is not None and not parted and not within_rule:
            tie = parting_tie(ta, tb, x, parting)
            parted = tie is not None
        log("tie flip: %d positional mismatches, %d substituted splits, "
            "gain sum rel diff %.2g%s%s" % (
                len(mism), sym, gain_rel, "" if sized else
                "; %d and %d splits" % (ta.num_leaves_actual - 1,
                                        tb.num_leaves_actual - 1),
                "" if tie is None else
                "; the trees part at node %d, %s, the splits before it %.2g "
                "apart" % (tie[0], {
                    "alike": "one leaf's rows split alike (a partition "
                             "tie), gains %.2g apart (%.2g of the root's)"
                             % tie[2:4],
                    "differently": "one leaf's rows split differently, "
                                   "gains %.2g apart (%.2g of the root's)"
                                   % tie[2:4],
                    "null": "a null split (%.2g of the root's gain)"
                            % tie[3],
                    "order": "the same splits in another order"}[tie[1]],
                    tie[4])))
        if ties is not None:
            ties.append({"positional": len(mism), "substituted": sym,
                         "gain_rel": float(gain_rel), "parting_tie": tie,
                         "after_parting_tie": parted})
        if not parted and not within_rule:
            raise AssertionError("kernel and plain trees differ beyond the "
                                 "f32 tie rule")
        # the next iteration's scores, and GOSS's sample, follow these trees
        parted = parted or regrow_gain_rel is not None
    return identical


# 4zza-4zzd, checkpoints and resilience (Queue 1 #12, #18), in the main
# process after 4zw: exact growth with float64 histograms on 4a's data (its kernel runs
# repeat themselves, phase 5), CKPT_ROUNDS iterations, 4zza's victim killed
# at the dispatch of iteration CKPT_KILL_AT and 4zzc's run crashed at
# CKPT_CRASH_AT; 4zzb a streamed frontier run on words of
# CKPT_STREAM_ROWS rows in 4 chunks, sent SIGTERM at the dispatch of
# iteration CKPT_STREAM_KILL_AT; 4zzd serves CKPT_SERVE_ROWS rows from a
# snapshot
CKPT_ROUNDS, CKPT_KILL_AT, CKPT_CRASH_AT = 8, 4, 3
CKPT_PARAMS = dict(PARAMS, **GROWTH_PARAMS["exact"], gpu_use_dp=True)
CKPT_STREAM_ROWS, CKPT_STREAM_CHUNK_ROWS = 262_144, 65_536
CKPT_STREAM_KILL_AT = 3
CKPT_STREAM_AUC_TOL = 1e-4
CKPT_SERVE_ROWS = 10_000
CKPT_CHILD_TIMEOUT_S = 240
CKPT_DATA = "ckpt_data.bin"     # 4a's Dataset for 4zza's child processes


class IterationClock:
    """Callbacks before and after each iteration that time it on the host,
    the card synchronised at both ends; the one after runs after the
    checkpoint callback (order 25), so a snapshot's cost is in the
    iteration's seconds. With ``manager`` (the checkpoint callback's) each
    row also has the snapshot's capture ms (the state's copy to the host)
    and write ms (npz, sha256, fsync and rename, the manifest's too); each
    row has the launch counts so far, and goes to ``sink`` (an open file)
    as a JSON line, flushed, so that a killed process leaves its rows."""

    def __init__(self, manager=None, sink=None):
        self.rows = []
        clock = {}

        class Before:
            before_iteration = True
            order = -50

            def __call__(self, env) -> None:
                torch.cuda.synchronize()
                clock["t0"] = time.perf_counter()

        rows = self.rows

        class After:
            before_iteration = False
            order = 26

            def __call__(self, env) -> None:
                torch.cuda.synchronize()
                row = {"iteration": env.iteration + 1,
                       "s": time.perf_counter() - clock["t0"]}
                if manager is not None:
                    row["capture_ms"] = manager.last_timing["capture_s"] * 1e3
                    row["write_ms"] = manager.last_timing["write_s"] * 1e3
                row["launches"] = read_counts()
                rows.append(row)
                if sink is not None:
                    sink.write(json.dumps(row) + "\n")
                    sink.flush()

        self.callbacks = [Before(), After()]


def run_ckpt_child(argv) -> int:
    """``--ckpt-child victim|resume --dir DIR --log FILE``: a child process
    of 4zza. It loads 4a's Dataset from CKPT_DATA beside DIR and trains
    CKPT_PARAMS for CKPT_ROUNDS iterations with a checkpoint a round into
    DIR, timing each iteration and its snapshot into FILE (IterationClock).
    The victim has ``fault_inject=kill@iter:CKPT_KILL_AT`` and dies of it;
    the resumer resumes from DIR and writes its model text to
    DIR/../resumed_model.txt."""
    import argparse
    from lightgbm_tpu_torch import callback as port_callback
    parser = argparse.ArgumentParser()
    parser.add_argument("mode", choices=("victim", "resume"))
    parser.add_argument("--dir", required=True)
    parser.add_argument("--log", required=True)
    args = parser.parse_args(argv)
    global LOG_PREFIX
    LOG_PREFIX = "[4zza %s] " % args.mode
    torch.set_num_threads(PART_THREADS)
    parent = os.path.dirname(os.path.abspath(args.dir))
    ds = lgb.Dataset(os.path.join(parent, CKPT_DATA))
    params = dict(CKPT_PARAMS)
    if args.mode == "victim":
        params["fault_inject"] = "kill@iter:%d" % CKPT_KILL_AT
    ckpt = port_callback.checkpoint(args.dir, period=1)
    with open(args.log, "w") as sink:
        clock = IterationClock(ckpt.manager, sink)
        reset_counts()
        bst = lgb.train(params, ds, num_boost_round=CKPT_ROUNDS,
                        callbacks=[ckpt] + clock.callbacks,
                        resume_from=(args.dir if args.mode == "resume"
                                     else None), verbose_eval=False)
    log("trained to iteration %d" % bst.current_iteration())
    with open(os.path.join(parent, "resumed_model.txt"), "w") as f:
        f.write(bst.model_to_string())
    return 0


def ckpt_child(mode: str, directory: str) -> tuple:
    """(return code, its IterationClock rows) of a 4zza child process."""
    log_path = os.path.join(os.path.dirname(directory), mode + ".jsonl")
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--ckpt-child", mode,
         "--dir", directory, "--log", log_path],
        env=dict(os.environ, OMP_NUM_THREADS=str(PART_THREADS)),
        timeout=CKPT_CHILD_TIMEOUT_S)
    with open(log_path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return proc.returncode, rows


def sum_counts(*launches) -> dict:
    return {name: sum(c[name] for c in launches) for name in launches[0]}


def f64_launches(label: str, launches: dict, trees=None) -> None:
    """Raises unless a float64 run launched histogram.cu's f64 variant and
    no other kernel, and (``trees`` given) once a pass: a root a tree and
    a split pass a split."""
    others = {k: v for k, v in launches.items()
              if v and k != "build_histogram_f64_cuda"}
    passes = launches["build_histogram_f64_cuda"]
    want = (None if trees is None else
            sum(t.num_leaves_actual - 1 for t in trees) + len(trees))
    if others or passes <= 0 or (want is not None and passes != want):
        raise AssertionError("path %s: %d f64 histogram passes (want %s), "
                             "other kernels %s" % (label, passes, want,
                                                   others))


def median_s(rows) -> float:
    """The median seconds of IterationClock ``rows``: robust to a
    process's first iteration (its kernels' and caches' warm-up) and to a
    run's first snapshot (the data profile's bincounts)."""
    return statistics.median(r["s"] for r in rows)


def snapshot_rows(label: str, rows) -> dict:
    """Logs each snapshot of IterationClock ``rows``; returns them with
    their medians."""
    for r in rows:
        log("path %s: snapshot %d: capture %.3f ms, write %.3f ms, its "
            "iteration %.3f s" % (label, r["iteration"], r["capture_ms"],
                                  r["write_ms"], r["s"]))
    return {"snapshots": [{k: r[k] for k in ("iteration", "capture_ms",
                                             "write_ms", "s")}
                          for r in rows],
            "capture_ms_median": statistics.median(
                r["capture_ms"] for r in rows),
            "write_ms_median": statistics.median(r["write_ms"] for r in rows),
            "s_per_iter_ckpt": median_s(rows)}


def model_trees(text: str) -> str:
    """A model text before its parameters, which echo each run's own."""
    return text.split("\nparameters:", 1)[0]


def drive_kill_and_resume(ds, x, y, tmp: str) -> tuple:
    """Path 4zza: CKPT_ROUNDS iterations of CKPT_PARAMS in this process
    with no checkpoint (the uninterrupted run, timed an iteration), then a
    child process killed by ``fault_inject=kill@iter:CKPT_KILL_AT``
    (SIGKILL, return code -9) after a snapshot a round, and a second one
    resuming its directory: its model text must be the uninterrupted
    run's byte for byte. Prints each snapshot's capture and write ms and
    the s/iter with checkpoints (the children's) and without (this
    run's). Returns (the path's result, the uninterrupted booster, its
    text, the directory)."""
    from lightgbm_tpu_torch.checkpoint import load_latest
    ds.save_binary(os.path.join(tmp, CKPT_DATA))
    clock = IterationClock()
    reset_counts()
    golden = lgb.train(CKPT_PARAMS, ds, num_boost_round=CKPT_ROUNDS,
                       callbacks=clock.callbacks, verbose_eval=False)
    golden_launches = read_counts()
    f64_launches("4zza", golden_launches, golden.models)
    text = golden.model_to_string()
    auc5 = auc(golden.predict(x, num_iteration=NUM_ITERS), y)
    want = JAX_F64_METRIC["4zn"]["auc"]
    if abs(auc5 - want) > F64_AUC_TOL:
        raise AssertionError("4zza: the first %d iterations' AUC %.10f is "
                             "not the JAX package's %.10f"
                             % (NUM_ITERS, auc5, want))
    directory = os.path.join(tmp, "ckpt_4zza")
    rc, victim = ckpt_child("victim", directory)
    if rc != -signal.SIGKILL or [r["iteration"] for r in victim] != list(
            range(1, CKPT_KILL_AT + 1)):
        raise AssertionError("4zza: the victim exited %s after iterations "
                             "%s" % (rc, [r["iteration"] for r in victim]))
    if load_latest(directory).iteration != CKPT_KILL_AT:
        raise AssertionError("4zza: the victim's newest snapshot is not "
                             "iteration %d" % CKPT_KILL_AT)
    rc, resumed = ckpt_child("resume", directory)
    if rc != 0 or [r["iteration"] for r in resumed] != list(
            range(CKPT_KILL_AT + 1, CKPT_ROUNDS + 1)):
        raise AssertionError("4zza: the resumer exited %s after iterations "
                             "%s" % (rc, [r["iteration"] for r in resumed]))
    with open(os.path.join(tmp, "resumed_model.txt")) as f:
        resumed_text = f.read()
    if resumed_text != text:
        raise AssertionError("4zza: the resumed model text is not the "
                             "uninterrupted run's")
    for rows in (victim, resumed):
        f64_launches("4zza", rows[-1]["launches"])
    log("path 4zza: f64 exact, %d iterations; the victim killed at the "
        "dispatch of iteration %d (exit %d), resumed from its snapshot %d: "
        "model text equal to the uninterrupted run's; AUC of the first %d "
        "iterations %.10f (JAX package %.10f)"
        % (CKPT_ROUNDS, CKPT_KILL_AT, -signal.SIGKILL, CKPT_KILL_AT,
           NUM_ITERS, auc5, want))
    out = dict(snapshot_rows("4zza", victim + resumed),
               rounds=CKPT_ROUNDS, kill_at=CKPT_KILL_AT,
               victim_rc=-signal.SIGKILL, model_text_equal=True,
               auc_5=auc5, s_per_iter_no_ckpt=median_s(clock.rows),
               no_ckpt_iterations=[r["s"] for r in clock.rows],
               launches=sum_counts(golden_launches, victim[-1]["launches"],
                                   resumed[-1]["launches"]))
    log("path 4zza: median s per iteration %.3f with a checkpoint a round "
        "(the two children), %.3f without (this process); capture median "
        "%.3f ms, write median %.3f ms; launches %s"
        % (out["s_per_iter_ckpt"], out["s_per_iter_no_ckpt"],
           out["capture_ms_median"], out["write_ms_median"],
           {k: v for k, v in out["launches"].items() if v}))
    return out, golden, text, directory


def drive_supervised_crash(ds, golden_text: str, no_ckpt_s: float,
                           tmp: str) -> dict:
    """Path 4zzc: CKPT_PARAMS with ``supervise=true``,
    ``fault_inject=crash@iter:CKPT_CRASH_AT`` and a checkpoint a round, in
    this process: one restart, resumed from snapshot CKPT_CRASH_AT, and
    the trees of 4zza's uninterrupted text byte for byte (the text up to
    its parameters, which echo this run's own). Its iterations and
    snapshots are timed (IterationClock) in the process that timed 4zza's
    uninterrupted run, ``no_ckpt_s`` a median iteration."""
    from lightgbm_tpu_torch import callback as port_callback
    from lightgbm_tpu_torch.obs.registry import get_registry
    from lightgbm_tpu_torch.resilience import faults
    restarts = get_registry().counter("lgbm_supervisor_restarts_total")
    before = restarts.value
    directory = os.path.join(tmp, "ckpt_4zzc")
    params = dict(CKPT_PARAMS, checkpoint_dir=directory, checkpoint_period=1,
                  fault_inject="crash@iter:%d" % CKPT_CRASH_AT,
                  supervise=True, supervise_backoff_s=0.01,
                  supervise_backoff_max_s=0.02)
    # the checkpoint_dir callback, given here to read its manager's times
    ckpt = port_callback.checkpoint(directory, period=1)
    clock = IterationClock(ckpt.manager)
    reset_counts()
    t0 = time.perf_counter()
    try:
        bst = lgb.train(params, ds, num_boost_round=CKPT_ROUNDS,
                        callbacks=[ckpt] + clock.callbacks,
                        verbose_eval=False)
        train_s = time.perf_counter() - t0
        fires = faults.active_plan().faults[0].fires
    finally:
        faults.clear_plan()
    launches = read_counts()
    f64_launches("4zzc", launches)
    count = int(restarts.value - before)
    if count != 1 or fires != 1:
        raise AssertionError("4zzc: %d restarts, the crash fired %d times"
                             % (count, fires))
    if model_trees(bst.model_to_string()) != model_trees(golden_text):
        raise AssertionError("4zzc: the supervised run's trees are not the "
                             "uninterrupted run's")
    if [r["iteration"] for r in clock.rows] != list(range(1,
                                                         CKPT_ROUNDS + 1)):
        raise AssertionError("4zzc: iterations %s completed"
                             % [r["iteration"] for r in clock.rows])
    log("path 4zzc: supervised f64 exact, crashed at the dispatch of "
        "iteration %d, %d restart, trees equal to 4zza's uninterrupted "
        "text; %.2f s for %d iterations and the restore; launches %s"
        % (CKPT_CRASH_AT, count, train_s, CKPT_ROUNDS,
           {k: v for k, v in launches.items() if v}))
    out = dict(snapshot_rows("4zzc", clock.rows), restarts=count,
               crash_at=CKPT_CRASH_AT, trees_equal=True, train_s=train_s,
               s_per_iter_no_ckpt=no_ckpt_s, launches=launches)
    log("path 4zzc: median s per iteration %.3f with a checkpoint a round, "
        "%.3f without (4zza's uninterrupted run, the same process); "
        "capture median %.3f ms, write median %.3f ms"
        % (out["s_per_iter_ckpt"], no_ckpt_s, out["capture_ms_median"],
           out["write_ms_median"]))
    return out


def drive_watcher_and_torn(golden, x, directory: str) -> dict:
    """Path 4zzd: a ServingEngine on the card watching 4zza's directory
    rolls its newest snapshot in (the guarded roll, its graphs captured on
    the poll), and answers CKPT_SERVE_ROWS rows as that snapshot's booster
    predicts them, bit for bit; then one more iteration of the
    uninterrupted run is saved there under ``ckpt_torn``: the watcher
    keeps the generation it serves and ``load_latest`` falls back to the
    snapshot before."""
    from lightgbm_tpu_torch.checkpoint import CheckpointManager, load_latest
    from lightgbm_tpu_torch.resilience import faults
    from lightgbm_tpu_torch.serving import ServingEngine
    eng = ServingEngine(device=torch.device("cuda", 0))
    watcher = eng.registry.watch_dir("4zzd", directory, engine=eng)
    t0 = time.perf_counter()
    if not watcher.poll():
        raise AssertionError("4zzd: the watcher rolled nothing in")
    roll_s = time.perf_counter() - t0
    snap_id, model_path = CheckpointManager(directory).latest_model()
    snap = lgb.Booster(model_file=model_path)
    rows = x[:CKPT_SERVE_ROWS]
    want = snap.predict(rows)
    require_equal(eng.predict("4zzd", rows), want, "4zzd snapshot %d"
                  % snap_id)
    if eng.registry.get("4zzd").profile is None:
        raise AssertionError("4zzd: the snapshot's bundle has no profile")
    generation = eng.registry.generation("4zzd")
    reset_counts()
    golden.update()
    launches = read_counts()
    f64_launches("4zzd", launches)
    faults.install_plan("ckpt_torn@snap:%d" % (CKPT_ROUNDS + 1))
    try:
        CheckpointManager(directory).save(golden)
    finally:
        faults.clear_plan()
    if watcher.poll() or eng.registry.generation("4zzd") != generation:
        raise AssertionError("4zzd: the watcher rolled a torn snapshot in")
    fallback = (load_latest(directory).iteration,
                CheckpointManager(directory).latest_model()[0])
    if fallback != (CKPT_ROUNDS, CKPT_ROUNDS):
        raise AssertionError("4zzd: load_latest and latest_model give %s, "
                             "not the snapshot before the torn one"
                             % (fallback,))
    require_equal(eng.predict("4zzd", rows), want,
                  "4zzd after the torn snapshot")
    log("path 4zzd: the watcher rolled snapshot %d in (%.2f s, its graphs "
        "captured on the poll), %d rows equal to its booster's predict; "
        "snapshot %d torn: not rolled, load_latest and the watcher at %d"
        % (snap_id, roll_s, len(rows), CKPT_ROUNDS + 1, fallback[0]))
    return {"snapshot": snap_id, "roll_s": roll_s, "rows": len(rows),
            "torn": CKPT_ROUNDS + 1, "fallback": fallback[0],
            "launches": launches}


class Preempted(Exception):
    """SIGTERM as an exception: 4zzb's victim runs in this process."""


def drive_streamed_resume(x, y, tmp: str) -> dict:
    """Path 4zzb: frontier growth on CKPT_STREAM_ROWS rows of 4b's data
    streamed from a .npy memory map in chunks of CKPT_STREAM_CHUNK_ROWS
    (packed words, the word variants of both kernels), CKPT_ROUNDS
    iterations with a checkpoint a round: uninterrupted; then a victim
    sent SIGTERM by ``kill@iter:CKPT_STREAM_KILL_AT:term`` (the callback
    latches it and writes the snapshot of that iteration before the signal
    goes on, here to a handler that raises, so the victim runs in this
    process); then a run resuming its directory, whose scores at its first
    iteration must be the snapshot's bit for bit and whose model text the
    snapshot's ``.model.txt``. The card's f32 sums do not repeat, so the
    resumed trees are held to the uninterrupted run's under phase 5's
    frontier tie rule (WAVE_PARTING) and its AUC within
    CKPT_STREAM_AUC_TOL."""
    from lightgbm_tpu_torch import callback as port_callback
    from lightgbm_tpu_torch.checkpoint import load_latest
    from lightgbm_tpu_torch.resilience import faults
    xs, ys = x[:CKPT_STREAM_ROWS], y[:CKPT_STREAM_ROWS]
    path = os.path.join(tmp, "ckpt_stream.npy")
    np.save(path, xs)
    params = dict(PARAMS, **GROWTH_PARAMS["frontier"],
                  data_stream_chunk_rows=CKPT_STREAM_CHUNK_ROWS)
    t0 = time.perf_counter()
    ds = lgb.Dataset(path, label=ys, params=params).construct()
    ingest_s = time.perf_counter() - t0

    def run(directory, resume=False, extra=()):
        reset_counts()
        bst = lgb.train(params, ds, num_boost_round=CKPT_ROUNDS,
                        callbacks=[port_callback.checkpoint(directory)]
                        + list(extra), verbose_eval=False,
                        resume_from=directory if resume else None)
        return bst, read_counts()

    golden, golden_launches = run(os.path.join(tmp, "ckpt_4zzb_g"))
    directory = os.path.join(tmp, "ckpt_4zzb")

    def preempt(signum, frame):
        raise Preempted()
    previous = signal.signal(signal.SIGTERM, preempt)
    faults.install_plan("kill@iter:%d:term" % CKPT_STREAM_KILL_AT)
    reset_counts()
    try:
        run(directory)
        raise AssertionError("4zzb: the victim was not preempted")
    except Preempted:
        victim_launches = read_counts()
    finally:
        faults.clear_plan()
        signal.signal(signal.SIGTERM, previous)
    handle = load_latest(directory)
    if handle.iteration != CKPT_STREAM_KILL_AT + 1:
        raise AssertionError("4zzb: the victim's snapshot is iteration %d"
                             % handle.iteration)
    # read now: the resumed run's retention deletes the snapshot's files
    with open(handle.model_path) as f:
        snap_text = f.read()
    restored = {}

    class FirstIteration:
        before_iteration = True
        order = -60

        def __call__(self, env) -> None:
            if not restored:
                impl = env.model._impl
                restored["scores"] = impl.scores.cpu().numpy()
                restored["bag_mask"] = impl._bag_mask.cpu().numpy()
                restored["text"] = env.model.model_to_string()
                restored["stream"] = impl._stream is not None

    resumed, launches = run(directory, resume=True,
                            extra=[FirstIteration()])
    same = {"scores": np.array_equal(
                restored["scores"].view(np.uint32),
                np.asarray(handle.arrays["scores"]).view(np.uint32)),
            "bag_mask": np.array_equal(restored["bag_mask"],
                                       handle.arrays["bag_mask"]),
            "model_text": restored["text"] == snap_text}
    if not all(same.values()) or not restored["stream"]:
        raise AssertionError("4zzb: the restored state is not the "
                             "snapshot's: %s" % same)
    word_launches("4zzb", launches, (CKPT_ROUNDS - handle.iteration)
                  * (CKPT_STREAM_ROWS // CKPT_STREAM_CHUNK_ROWS))
    rows_t = torch.as_tensor(xs, dtype=torch.float64, device="cuda")
    ties = []
    identical = trees_match(resumed.models, golden.models, ties,
                            WAVE_PARTING, None, rows_t)
    auc_resumed = auc(resumed.predict(xs, raw_score=True), ys)
    auc_golden = auc(golden.predict(xs, raw_score=True), ys)
    if abs(auc_resumed - auc_golden) > CKPT_STREAM_AUC_TOL:
        raise AssertionError("4zzb: the resumed AUC %.6f is more than %g "
                             "from the uninterrupted run's %.6f" % (
                                 auc_resumed, CKPT_STREAM_AUC_TOL,
                                 auc_golden))
    log("path 4zzb: streamed frontier on words, %d rows in chunks of %d "
        "(ingest %.2f s); SIGTERM at the dispatch of iteration %d, snapshot "
        "%d; restored scores, bag mask and model text the snapshot's bit "
        "for bit; resumed trees %s the uninterrupted run's (%d ties), AUC "
        "%.8f against %.8f; the resumed run's launches %s"
        % (CKPT_STREAM_ROWS, CKPT_STREAM_CHUNK_ROWS, ingest_s,
           CKPT_STREAM_KILL_AT, handle.iteration,
           "identical to" if identical else "within the tie rule of",
           len(ties), auc_resumed, auc_golden,
           {k: v for k, v in launches.items() if v}))
    return {"rows": CKPT_STREAM_ROWS, "chunk_rows": CKPT_STREAM_CHUNK_ROWS,
            "ingest_s": ingest_s, "snapshot": handle.iteration,
            "restored_equal": same, "identical": identical, "ties": ties,
            "auc": auc_resumed, "auc_uninterrupted": auc_golden,
            "resumed_launches": launches,
            "launches": sum_counts(golden_launches, victim_launches,
                                   launches)}


def drive_checkpoint_paths(ds, x, y, tmp: str, t_start: float,
                           refs: dict) -> dict:
    """Paths 4zza, 4zzc and 4zzd on 4a's data ``x``, ``y``, binned as
    ``ds``, then 4zze (4zza's booster refitted) and 4zzg (the fleet over a
    copy of 4zza's directory taken before 4zzd writes there; the module
    docstring). 4zza's first NUM_ITERS trees go in ``refs`` (4zzj's
    reference)."""
    import copy
    import shutil
    out = {}
    log_phase(t_start, "4zza. kill and resume, float64")
    out["4zza"], golden, text, directory = drive_kill_and_resume(ds, x, y,
                                                                 tmp)
    refs["4zza"] = copy.deepcopy(golden.models[:NUM_ITERS])
    fleet_dir = os.path.join(tmp, "fleet_4zzg")
    shutil.copytree(directory, os.path.join(fleet_dir, "ckpt"))
    log_phase(t_start, "4zzc. a supervised crash")
    out["4zzc"] = drive_supervised_crash(
        ds, text, out["4zza"]["s_per_iter_no_ckpt"], tmp)
    log_phase(t_start, "4zzd. the serving watcher and a torn snapshot")
    out["4zzd"] = drive_watcher_and_torn(golden, x, directory)
    log_phase(t_start, "4zze. refit of 4zza's booster on a shifted window")
    # 4zza's model of CKPT_ROUNDS iterations (4zzd trained golden one more)
    out["4zze"] = drive_refit_path(lgb.Booster(model_str=text))[0]
    del golden
    log_phase(t_start, "4zzg. the fleet: drift, refit, a rolling deploy")
    out["4zzg"] = drive_fleet_path(fleet_dir)
    return out


# ---- 4zze-4zzg. refit, QoS and the fleet (#15 slice a) -----------------
# the refit window: bench.py's rows of another seed with features 0-3
# shifted by REFIT_SHIFT (a covariate drift of a quarter deviation), the
# labels of the unshifted rows
REFIT_SHIFT, REFIT_SHIFTED = 0.25, 4
REFIT_DECAY = 0.5
REFIT_LEAF_RTOL, REFIT_LEAF_ATOL = 1e-5, 1e-6
REFIT_AUC_TOL = 1e-5
# 4zza's f64 model (CKPT_PARAMS, CKPT_ROUNDS iterations) in the JAX
# package: its AUC on the training rows, and on the window after the JAX
# package refitted it there at REFIT_DECAY (154 s on the CPU):
#   JAX_PLATFORMS=cpu python scripts/jax_reference_auc.py --refit
JAX_REFIT_TRAIN_AUC = 0.9648963913219922
JAX_REFIT_AUC = 0.9471359215577544
# 4zzf: 4m (binary) and 4r (5 classes) on one engine under QoS
QOS_WEIGHTS = "a=4,b=1"
QOS_QUOTA_ROWS = 256
QOS_ROWS = 32                  # rows a request
QOS_FLOOD_THREADS = 8          # open loop on a, past its quota
QOS_STEADY_THREADS = 4         # closed loop on b, within its quota
QOS_SECONDS = 4.0
# each dispatch of the saturation phase is held this long after the
# engine's answer: the card answers a batch in about a millisecond, and a
# dispatch takes every queued request of its model, so without the hold
# the flooding threads cannot refill a's queue before the next pick, and
# the queue (work-conserving) serves whichever model has work instead of
# the weights' share
QOS_HOLD_S = 0.003
QOS_RATIO_TOL = 0.1
QOS_CASCADE_TREES = 2
QOS_TUNER_RUNGS = 4
QOS_TUNER_REQUESTS = 30        # fresh samples of one bucket a step
# 4zzg: two replica processes of build_app over a copy of 4zza's directory
FLEET_REPLICAS = ("a", "b")
FLEET_SHIFT = 1.0              # traffic and window: features 0-3 + 1 sd
FLEET_WINDOW_ROWS = 250_000
FLEET_PAYLOADS, FLEET_PAYLOAD_ROWS = 32, 64
FLEET_TRAFFIC_THREADS = 1      # a replica
FLEET_WAIT_S = 120.0


def shifted_window(data, n: int, seed: int, shift: float):
    """``data(n, seed=seed)`` with features 0..REFIT_SHIFTED-1 moved by
    ``shift``; the labels are the unshifted rows'."""
    x, y = data(n, seed=seed)
    x = np.array(x, copy=True)
    x[:, :REFIT_SHIFTED] += shift
    return x, y


def live_leaves(models) -> list:
    return [np.asarray(t.leaf_value[:t.num_leaves_actual], np.float64)
            for t in models]


def tree_structure(models) -> list:
    out = []
    for t in models:
        nn = max(int(t.num_leaves_actual) - 1, 0)
        out.append(tuple(np.asarray(getattr(t, f)[:nn]).tobytes() for f in
                         ("split_feature", "threshold", "left_child",
                          "right_child", "default_left")))
    return out


def drive_refit(label: str, bst, xw, yw) -> tuple:
    """One refit of ``bst`` on the window ``xw``, ``yw`` at REFIT_DECAY on
    the card (``fleet.Refitter``), held against the host loop
    (``refit_device=false``) within REFIT_LEAF_RTOL / REFIT_LEAF_ATOL,
    ``decay_rate=1.0`` (the leaf tables byte for byte), the trees'
    structure (byte for byte) and a held Refitter's later cycle against a
    one-shot refit (bit for bit). Returns (the path's numbers, the
    refitted booster)."""
    from lightgbm_tpu_torch.fleet import Refitter, refit_booster
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    held = Refitter(bst)
    dev = held.refit(xw, yw, decay_rate=REFIT_DECAY)
    refit_s = time.perf_counter() - t0
    launches = read_counts()
    timing = dict(held.last_timing)
    host_bst = lgb.Booster(model_str=bst.model_to_string())
    host_bst.config.refit_device = False
    t0 = time.perf_counter()
    host = host_bst.refit(xw, yw, decay_rate=REFIT_DECAY)
    host_s = time.perf_counter() - t0
    worst = 0.0
    for i, (a, b) in enumerate(zip(live_leaves(dev.models),
                                   live_leaves(host.models))):
        err = np.abs(a - b)
        if (err > REFIT_LEAF_ATOL + REFIT_LEAF_RTOL * np.abs(b)).any():
            raise AssertionError("%s: tree %d's refitted leaves %.3g off "
                                 "the host loop's" % (label, i, err.max()))
        worst = max(worst, float(err.max()))
    if tree_structure(dev.models) != tree_structure(bst.models):
        raise AssertionError("%s: the refit changed a tree's structure"
                             % label)
    kept = held.refit(xw, yw, decay_rate=1.0)
    if not all(np.array_equal(a.leaf_value, b.leaf_value)
               for a, b in zip(kept.models, bst.models)):
        raise AssertionError("%s: decay_rate=1.0 changed a leaf" % label)
    again = held.refit(xw, yw, decay_rate=REFIT_DECAY)
    shot = refit_booster(bst, xw, yw, decay_rate=REFIT_DECAY)
    for a, b, c in zip(again.models, shot.models, dev.models):
        if not (np.array_equal(a.leaf_value, b.leaf_value)
                and np.array_equal(a.leaf_value, c.leaf_value)):
            raise AssertionError("%s: a held Refitter's cycle is not the "
                                 "one-shot refit's bit for bit" % label)
    log("path %s: %d trees refitted on %d rows at decay %g: %.3f s on the "
        "card (routing %.2f ms, the loop over iterations %.2f ms) against "
        "%.3f s for the host loop; leaves within %.3g of the host loop's; "
        "structure, decay 1.0 and the held refitter equal"
        % (label, len(bst.models), len(xw), REFIT_DECAY, refit_s,
           timing["route_s"] * 1e3, timing["loop_s"] * 1e3, host_s, worst))
    return ({"launches": launches, "rows": len(xw),
             "trees": len(bst.models), "refit_s": refit_s,
             "route_ms": timing["route_s"] * 1e3,
             "loop_ms": timing["loop_s"] * 1e3, "host_s": host_s,
             "leaf_err_vs_host": worst}, dev)


def drive_refit_path(golden) -> tuple:
    """Path 4zze: ``golden``, 4zza's f64 model of CKPT_ROUNDS iterations,
    refitted on a window of MAIN_ROWS (``shifted_window`` of bench.py's
    data, seed 1); its AUC there held to the JAX package's within
    REFIT_AUC_TOL. Returns (the path's numbers, the refitted booster)."""
    if golden.current_iteration() != CKPT_ROUNDS:
        raise AssertionError("4zze: the model has %d iterations, not %d"
                             % (golden.current_iteration(), CKPT_ROUNDS))
    x, y = bench_data(MAIN_ROWS)
    trained = auc(golden.predict(x), y)
    del x, y
    if abs(trained - JAX_REFIT_TRAIN_AUC) > F64_AUC_TOL:
        raise AssertionError("4zze: 4zza's %d-iteration AUC %.10f is not the "
                             "JAX package's %.10f: the trees parted"
                             % (CKPT_ROUNDS, trained, JAX_REFIT_TRAIN_AUC))
    xw, yw = shifted_window(bench_data, MAIN_ROWS, 1, REFIT_SHIFT)
    out, dev = drive_refit("4zze", golden, xw, yw)
    before = auc(golden.predict(xw), yw)
    after = auc(dev.predict(xw), yw)
    if abs(after - JAX_REFIT_AUC) > REFIT_AUC_TOL:
        raise AssertionError("4zze: the refitted AUC %.10f is not the JAX "
                             "package's %.10f" % (after, JAX_REFIT_AUC))
    log("path 4zze: 4zza's AUC %.10f (JAX package %.10f); on the window "
        "%.10f before the refit, %.10f after (JAX package %.10f)"
        % (trained, JAX_REFIT_TRAIN_AUC, before, after, JAX_REFIT_AUC))
    out.update(auc_train=trained, auc_before=before, auc=after,
               jax_auc=JAX_REFIT_AUC)
    return out, dev


def drive_multiclass_refit(mc_bst) -> dict:
    """Path 4zze's k>1 row: 4r's 5-class booster refitted on
    MULTICLASS_ROWS rows (``shifted_window`` of the multiclass data, seed
    1)."""
    xw, yw = shifted_window(multiclass_data, MULTICLASS_ROWS, 1,
                            REFIT_SHIFT)
    out, dev = drive_refit("4zze (4r, 5 classes)", mc_bst, xw, yw)
    out["multi_logloss_before"] = float(np.mean(-np.log(np.maximum(
        mc_bst.predict(xw)[np.arange(len(yw)), yw.astype(np.int64)],
        1e-15))))
    out["multi_logloss"] = float(np.mean(-np.log(np.maximum(
        dev.predict(xw)[np.arange(len(yw)), yw.astype(np.int64)], 1e-15))))
    log("path 4zze (4r): multi_logloss on the window %.6f before, %.6f "
        "after" % (out["multi_logloss_before"], out["multi_logloss"]))
    return out


def drive_qos_path(a_bst, b_bst) -> dict:
    """Path 4zzf: ``a_bst`` (4m, binary) and ``b_bst`` (4r, 5 classes) as
    models a and b of one app on the card built from the config
    (``serve_qos_weights=QOS_WEIGHTS``, ``serve_qos_quota_rows``, a
    cascade of QOS_CASCADE_TREES iterations, ``serve_latency_budget_ms``).
    QOS_FLOOD_THREADS threads flood a past its quota while
    QOS_STEADY_THREADS keep b busy within its own, each dispatch held
    QOS_HOLD_S so that both stay queued: every shed request is a's, and
    the rows served converge to a's weight over b's within
    QOS_RATIO_TOL. Then the budget is set below the measured p99 and the
    autotuner walks the margin down one rung a step. Every answer is the
    host emulation of the cascade at the margin it was served at, and no
    graph is captured after warmup outside the credited retunes."""
    import threading
    from lightgbm_tpu_torch import serving
    from lightgbm_tpu_torch.log import OverloadedError
    models = {"a": (a_bst, categorical_data(SERVE_ROWS, seed=2)[0]),
              "b": (b_bst, multiclass_data(SERVE_ROWS, seed=2)[0])}
    refs = {m: serve_references(b, rows, QOS_CASCADE_TREES)
            for m, (b, rows) in models.items()}
    ks = {m: b.num_model_per_iteration() for m, (b, _) in models.items()}
    convert = {m: b._impl.objective.convert_output
               for m, (b, _) in models.items()}
    top = float(np.median(stage1_margins(refs["a"]["first"], 1)))
    app = serving.build_app(Config({
        "serve_qos_weights": QOS_WEIGHTS,
        "serve_qos_quota_rows": QOS_QUOTA_ROWS,
        "serving_cascade_trees": QOS_CASCADE_TREES,
        "serving_cascade_margin": top, "serve_latency_budget_ms": 1.0,
        "serve_qos_tune_interval_s": 3600.0, "serve_deadline_ms": 2.0,
        "verbosity": -1}))
    eng, queue, tuner = app.engine, app.queue, app.tuner
    try:
        for m, (b, _) in models.items():
            eng.registry.register(b.as_serving_bundle(m))
        # transformed outputs: a retune re-warms those entries (the raw
        # ones would be captured on their first request after it)
        warmed = eng.warmup(raw_scores=(False,))

        def want(m, lo, n, margin):
            raw, _ = cascade_emulation(refs[m]["first"][lo:lo + n],
                                       refs[m][True][lo:lo + n], ks[m],
                                       margin)
            return np.asarray(convert[m](raw))

        # ---- QoS under saturation ------------------------------------
        stop = threading.Event()
        faults, shed = [], {"a": 0, "b": 0}
        lock = threading.Lock()

        def flood(i):
            r = np.random.RandomState(i)
            futures = []
            try:
                while not stop.is_set():
                    lo = int(r.randint(0, SERVE_ROWS - QOS_ROWS))
                    try:
                        futures.append((lo, queue.submit(
                            "a", models["a"][1][lo:lo + QOS_ROWS])))
                    except OverloadedError:
                        with lock:
                            shed["a"] += 1
                        time.sleep(0.0005)
                for lo, f in futures:
                    require_equal(f.result(timeout=60),
                                  want("a", lo, QOS_ROWS, top),
                                  "4zzf a %d rows" % QOS_ROWS)
            except Exception as e:  # noqa: BLE001 - raised after the join
                faults.append(e)

        def steady(i):
            r = np.random.RandomState(100 + i)
            try:
                while not stop.is_set():
                    lo = int(r.randint(0, SERVE_ROWS - QOS_ROWS))
                    try:
                        got = queue.predict("b", models["b"][1][
                            lo:lo + QOS_ROWS])
                    except OverloadedError:
                        with lock:
                            shed["b"] += 1
                        continue
                    require_equal(got, want("b", lo, QOS_ROWS, top),
                                  "4zzf b %d rows" % QOS_ROWS)
            except Exception as e:  # noqa: BLE001 - raised after the join
                faults.append(e)

        threads = ([threading.Thread(target=flood, args=(i,))
                    for i in range(QOS_FLOOD_THREADS)]
                   + [threading.Thread(target=steady, args=(i,))
                      for i in range(QOS_STEADY_THREADS)])
        predict = eng.predict

        def held(*args, **kwargs):
            out = predict(*args, **kwargs)
            time.sleep(QOS_HOLD_S)
            return out
        eng.predict = held
        try:
            for t in threads:
                t.start()
            time.sleep(QOS_SECONDS)
            stop.set()
            for t in threads:
                t.join(timeout=120)
        finally:
            eng.predict = predict
        if faults or any(t.is_alive() for t in threads):
            raise AssertionError("4zzf: %s" % (faults[:3] or "a caller hung"))
        qos = queue.stats()["qos"]
        if shed["b"] or qos["b"]["shed"] or not shed["a"] \
                or qos["a"]["shed"] != shed["a"]:
            raise AssertionError("4zzf: shed %s, the policy's %s" % (
                shed, {m: qos[m]["shed"] for m in qos}))
        ratio = qos["a"]["served_rows"] / qos["b"]["served_rows"]
        weight = qos["a"]["weight"] / qos["b"]["weight"]
        if abs(ratio / weight - 1.0) > QOS_RATIO_TOL:
            raise AssertionError("4zzf: rows served a:b %.3f, weights %.3f"
                                 % (ratio, weight))
        log("path 4zzf: %.1f s of saturation, %d of a's requests shed past "
            "its quota of %d rows, none of b's; rows served a %d, b %d "
            "(%.3f, weights %.1f)" % (QOS_SECONDS, shed["a"], QOS_QUOTA_ROWS,
                                      qos["a"]["served_rows"],
                                      qos["b"]["served_rows"], ratio,
                                      weight))

        # ---- the autotuner: a budget below the measured p99 ----------
        rows, nb = models["a"][1], eng.min_bucket
        for lo in range(0, QOS_TUNER_REQUESTS * nb, nb):
            require_equal(eng.predict("a", rows[lo:lo + nb]),
                          want("a", lo, nb, top), "4zzf before the tuner")
        # the smallest bucket's p99, which every later step judges alone
        p99 = float(eng.metrics.bucket_latency()[str(nb)]["p99_ms"])
        tuner.budget_ms = p99 / 10.0
        tuner.step()       # judges every bucket so far: one rung down
        margins = [float(eng.cascade_margin)]
        for _ in range(QOS_TUNER_RUNGS):
            margin = float(eng.cascade_margin)
            for lo in range(0, QOS_TUNER_REQUESTS * nb, nb):
                require_equal(eng.predict("a", rows[lo:lo + nb]),
                              want("a", lo, nb, margin),
                              "4zzf at margin %g" % margin)
            moved = tuner.step()
            margins.append(float(eng.cascade_margin))
        if margins != tuner.ladder[1:] + [tuner.ladder[-1]] * 2:
            raise AssertionError("4zzf: the tuner's margins %s, ladder %s"
                                 % (margins, tuner.ladder))
        if moved is not None:
            raise AssertionError("4zzf: the tuner moved past its last rung")
        after = {"captures": eng.metrics.recompiles_after_warmup(),
                 "cache_misses": eng.metrics.cache_misses_after_warmup()}
        if after["captures"] or after["cache_misses"]:
            raise AssertionError("4zzf: %s after warmup" % after)
        log("path 4zzf: p99 %.3f ms, budget %.3f ms: the tuner's margins %s "
            "(ladder %s, %d retunes); every answer the cascade's emulation "
            "at its margin; captures and cache misses after warmup %s"
            % (p99, tuner.budget_ms, margins, tuner.ladder, tuner.retunes,
               after))
        return {"launches": {name: 0 for name in read_counts()},
                "warmed": warmed, "shed": shed, "served_rows": {
                    m: qos[m]["served_rows"] for m in qos},
                "ratio": ratio, "p99_ms": p99, "budget_ms": tuner.budget_ms,
                "margins": margins, "retunes": tuner.retunes,
                "after_warmup": after}
    finally:
        app.close()


def fleet_get(base: str, path: str):
    import urllib.request
    with urllib.request.urlopen(base + path, timeout=30) as r:
        body = r.read()
    return body.decode() if path == "/metrics/cluster" else json.loads(body)


def run_fleet_replica(argv) -> int:
    """``--fleet-replica NAME --dir DIR``: one replica of 4zzg. Builds the
    app from the config (``checkpoint_dir`` DIR/ckpt, ``fleet_kv_dir``
    DIR/kv, ``fleet_replica`` NAME), which rolls the directory's newest
    snapshot in turn with the replicas before it, warms every bucket,
    serves HTTP on 127.0.0.1 and publishes its address under
    ``http/NAME`` in the KV; SIGTERM ends it."""
    import argparse
    import threading
    from lightgbm_tpu_torch import serving
    from lightgbm_tpu_torch.fleet import FileKvClient
    parser = argparse.ArgumentParser()
    parser.add_argument("name")
    parser.add_argument("--dir", required=True)
    args = parser.parse_args(argv)
    global LOG_PREFIX
    LOG_PREFIX = "[4zzg %s] " % args.name
    torch.set_num_threads(1)
    cfg = Config({"checkpoint_dir": os.path.join(args.dir, "ckpt"),
                  "fleet_kv_dir": os.path.join(args.dir, "kv"),
                  "fleet_replica": args.name,
                  "fleet_announce_period_s": 0.1, "serve_min_bucket": 16,
                  "serve_max_batch": 256, "obs_drift_min_rows": 512,
                  "verbosity": -1})
    app = serving.build_app(cfg)
    warmed = app.engine.warmup()
    server = serving.make_server(app, "127.0.0.1", 0)
    FileKvClient(cfg.fleet_kv_dir).key_value_set(
        "http/" + args.name, "http://127.0.0.1:%d" % server.server_address[1])
    log("serving snapshot %d, %d entries warmed"
        % (app.watcher._last_id, warmed))
    signal.signal(signal.SIGTERM, lambda *_: threading.Thread(
        target=server.shutdown, daemon=True).start())
    try:
        server.serve_forever()
    finally:
        server.server_close()
        app.close()
    return 0


def wait_for(pred, timeout_s: float = FLEET_WAIT_S, what: str = ""):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(0.02)
    raise AssertionError("4zzg: %s within %.0f s" % (what, timeout_s))


class NanLeaves:
    """A refitted booster whose published model text has tree 0's leaf
    values replaced by NaN (the model text writer takes finite values
    only): a snapshot that passes the manifest's checksums and that the
    guarded roll's canary must refuse."""

    def __init__(self, booster):
        self._impl = booster._impl
        lines = booster.model_to_string().split("\n")
        first = next(i for i, line in enumerate(lines)
                     if line.startswith("leaf_value="))
        count = len(lines[first].split("=", 1)[1].split())
        lines[first] = "leaf_value=" + " ".join(["nan"] * count)
        self._text = "\n".join(lines)

    def model_to_string(self) -> str:
        return self._text


def drive_fleet_path(workdir: str) -> dict:
    """Path 4zzg, the fleet loop on the card: two replica processes
    (``run_fleet_replica``) over ``workdir``'s copy of 4zza's directory;
    drifted traffic (features 0-3 + FLEET_SHIFT) from FLEET_TRAFFIC_THREADS
    threads a replica turns both to ``drift: warn``; the refit worker here
    refits the served booster on a window of that traffic
    (``fleet.Refitter``) and publishes it with the window's profile
    (``save_refit``); the replicas roll it one at a time under the traffic.
    Every answer is the old or the refitted booster's ``predict`` bit for
    bit, the refitted one's once a replica has announced the roll; nothing
    is dropped, errored or shed; no graph is captured after warmup; drift
    returns to ok; ``/stats/cluster`` shows both on the refit. Then a torn
    snapshot (``ckpt_torn``) is passed over by both (its checksum fails),
    and one whose leaf table is NaN (``NanLeaves``), which passes the
    manifest, is refused by the first replica's canary and skipped by the
    second without staging it."""
    import threading
    from lightgbm_tpu_torch.checkpoint import CheckpointManager
    from lightgbm_tpu_torch.fleet import (FileKvClient, ReplicaAnnouncer,
                                          Refitter)
    from lightgbm_tpu_torch.obs.drift import DataProfile
    from lightgbm_tpu_torch.resilience import faults as port_faults
    ckpt = os.path.join(workdir, "ckpt")
    kv = FileKvClient(os.path.join(workdir, "kv"))
    mgr = CheckpointManager(ckpt)
    base_id, base_path = mgr.latest_model()
    old = lgb.Booster(model_file=base_path)
    xt = shifted_window(bench_data, FLEET_PAYLOADS * FLEET_PAYLOAD_ROWS, 3,
                        FLEET_SHIFT)[0]
    payloads = [xt[i * FLEET_PAYLOAD_ROWS:(i + 1) * FLEET_PAYLOAD_ROWS]
                for i in range(FLEET_PAYLOADS)]
    bodies = [json.dumps({"model": "default", "data": p.tolist()}).encode()
              for p in payloads]
    # one predict over every payload's rows: a row's output does not
    # depend on the rows beside it
    old_out = np.split(old.predict(xt), FLEET_PAYLOADS)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    stop = threading.Event()
    threads = []
    procs = {name: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--fleet-replica", name,
         "--dir", workdir], env=env) for name in FLEET_REPLICAS}
    try:
        t0 = time.perf_counter()
        bases = wait_for(lambda: (
            {n: kv.try_get("http/" + n) for n in FLEET_REPLICAS}
            if all(kv.try_get("http/" + n) for n in FLEET_REPLICAS)
            else None), what="both replicas serving")
        up_s = time.perf_counter() - t0

        def announced():
            fleet = ReplicaAnnouncer.read_fleet(kv)
            return {n: fleet.get(n, {}) for n in FLEET_REPLICAS}
        if {d.get("snap_id") for d in announced().values()} != {base_id}:
            raise AssertionError("4zzg: the replicas do not serve snapshot "
                                 "%d: %s" % (base_id, announced()))

        # ---- drifted traffic --------------------------------------------
        import urllib.error
        import urllib.request
        records, counts = [], {"errors": 0, "shed": 0}
        lock = threading.Lock()

        def traffic(name, seed):
            r = np.random.RandomState(seed)
            while not stop.is_set():
                i = int(r.randint(FLEET_PAYLOADS))
                t1 = time.perf_counter()
                try:
                    with urllib.request.urlopen(urllib.request.Request(
                            bases[name] + "/predict", data=bodies[i]),
                            timeout=60) as resp:
                        out = json.loads(resp.read())["predictions"]
                except urllib.error.HTTPError as e:
                    with lock:
                        counts["shed" if e.code == 503 else "errors"] += 1
                    continue
                except Exception:  # noqa: BLE001 - counted, checked below
                    with lock:
                        counts["errors"] += 1
                    continue
                t2 = time.perf_counter()
                with lock:
                    records.append((name, i, t1, t2, np.asarray(out)))
        threads += [threading.Thread(target=traffic, args=(n, 10 * j + k),
                                     daemon=True)
                    for j, n in enumerate(FLEET_REPLICAS)
                    for k in range(FLEET_TRAFFIC_THREADS)]
        for t in threads:
            t.start()
        t0 = time.perf_counter()
        for name in FLEET_REPLICAS:
            wait_for(lambda: fleet_get(bases[name], "/healthz")["drift"]
                     == "warn", what="replica %s at drift: warn" % name)
        warn_s = time.perf_counter() - t0

        # ---- the refit worker ---------------------------------------------
        t0 = time.perf_counter()
        xw, yw = shifted_window(bench_data, FLEET_WINDOW_ROWS, 4,
                                FLEET_SHIFT)
        refitted = Refitter(old).refit(xw, yw, decay_rate=0.0)
        new_out = np.split(refitted.predict(xt), FLEET_PAYLOADS)
        window = lgb.Dataset(xw, label=yw,
                             params={"verbosity": -1}).construct()
        entry = mgr.save_refit(
            refitted, data_profile=DataProfile.from_binned_dataset(
                window._binned))
        del window
        refit_id = int(entry["id"])
        t_pub = time.perf_counter()
        worker_s = t_pub - t0
        rolled = {}
        for name in FLEET_REPLICAS:
            wait_for(lambda: announced()[name].get("snap_id") == refit_id,
                     what="replica %s on snapshot %d" % (name, refit_id))
            rolled[name] = time.perf_counter()
        for name in FLEET_REPLICAS:
            wait_for(lambda: fleet_get(bases[name], "/healthz")["drift"]
                     == "ok", what="replica %s back at drift: ok" % name)

        # ---- a torn snapshot, then one the canary refuses -------------------
        port_faults.install_plan("ckpt_torn@snap:%d" % (refit_id + 1))
        try:
            mgr.save_refit(refitted)
        finally:
            port_faults.clear_plan()
        bad_id = int(mgr.save_refit(NanLeaves(refitted))["id"])
        wait_for(lambda: all(bad_id in d.get("rejected", ())
                             for d in announced().values()),
                 what="both replicas rejecting snapshot %d" % bad_id)
        time.sleep(0.5)
        stop.set()
        for t in threads:
            t.join(timeout=120)
        if any(t.is_alive() for t in threads):
            raise AssertionError("4zzg: a traffic thread hung")

        # ---- what the fleet did -------------------------------------------
        stats = {n: fleet_get(bases[n], "/stats") for n in FLEET_REPLICAS}
        cluster = fleet_get(bases["a"], "/stats/cluster")
        prom = fleet_get(bases["b"], "/metrics/cluster")
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        for proc in procs.values():
            if proc.poll() is None:
                proc.terminate()
        for proc in procs.values():
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    if counts["errors"] or counts["shed"] or len(records) < 100:
        raise AssertionError("4zzg: %d answers, %s" % (len(records), counts))
    for name, i, t1, _, got in records:
        want = [new_out[i]] if t1 > rolled[name] else [old_out[i],
                                                       new_out[i]]
        if not any(got.shape == w.shape and np.array_equal(got, w)
                   for w in want):
            raise AssertionError("4zzg: replica %s answered payload %d with "
                                 "neither booster's predict" % (name, i))
    for name in FLEET_REPLICAS:
        s = stats[name]
        if s["recompiles_after_warmup"] or s["errors"] or s["shed"]:
            raise AssertionError("4zzg: replica %s: %s" % (name, {
                k: s[k] for k in ("recompiles_after_warmup", "errors",
                                  "shed")}))
        if s["replica"]["snap_id"] != refit_id \
                or bad_id not in s["replica"]["rejected"]:
            raise AssertionError("4zzg: replica %s announces %s"
                                 % (name, s["replica"]))
    rollbacks = {n: stats[n]["rollbacks"] for n in FLEET_REPLICAS}
    if rollbacks != {"a": 1, "b": 0}:
        raise AssertionError("4zzg: canary refusals %s (the first replica "
                             "stages the bad snapshot, the second never)"
                             % rollbacks)
    fleet = cluster["fleet"]
    if (fleet["live"], fleet["snap_id_min"], fleet["snap_id_max"],
            fleet["rolling"]) != (2, refit_id, refit_id, False):
        raise AssertionError("4zzg: /stats/cluster %s" % fleet)
    if "lgbm_fleet_live_replicas 2" not in prom:
        raise AssertionError("4zzg: /metrics/cluster lacks the live count")
    served = lgb.Booster(model_file=CheckpointManager(ckpt).latest_model()[1])
    if tree_structure(served.models) != tree_structure(old.models):
        raise AssertionError("4zzg: the served trees changed structure")
    roll_s = {"a": rolled["a"] - t_pub, "b": rolled["b"] - rolled["a"]}
    during = [t2 - t1 for _, _, t1, t2, _ in records
              if t_pub <= t1 <= rolled["b"]]
    p99 = float(np.percentile(np.asarray(during) * 1e3, 99)) if during \
        else float("nan")
    steady = [t2 - t1 for _, _, t1, t2, _ in records if t1 > rolled["b"]]
    log("path 4zzg: replicas up in %.2f s; drift warn after %.2f s of "
        "traffic; refit worker %.2f s (%d rows); roll of snapshot %d: "
        "replica a %.3f s after the publication, b %.3f s after a; p99 %.2f "
        "ms over %d requests during the roll (%.2f ms after it); %d answers, "
        "0 errors, 0 shed; snapshot %d torn and passed over, snapshot %d "
        "refused by a's canary and skipped by b; /stats/cluster %s"
        % (up_s, warn_s, worker_s, FLEET_WINDOW_ROWS, refit_id,
           roll_s["a"], roll_s["b"], p99, len(during),
           float(np.percentile(np.asarray(steady) * 1e3, 99)) if steady
           else float("nan"), len(records), refit_id + 1, bad_id, fleet))
    return {"launches": {name: 0 for name in read_counts()},
            "base_snapshot": base_id, "refit_snapshot": refit_id,
            "rejected_snapshot": bad_id, "answers": len(records),
            "up_s": up_s, "warn_s": warn_s, "refit_worker_s": worker_s,
            "roll_s": roll_s, "p99_during_roll_ms": p99,
            "requests_during_roll": len(during), "cluster": fleet,
            "rollbacks": rollbacks}


# 4zzh and 4zzi, observability (Queue 1 #15 slice b). 4zzh in part
# compare after 4zw on 4b's data: frontier OBS_ROUNDS rounds at each level
# in turns; exact f64 (4zza's repeatable path) OBS_F64_ROUNDS rounds at
# full with every training telemetry option, against its none run; NaN
# gradients at iteration OBS_NAN_AT on OBS_NAN_ROWS rows. 4zzi in part
# workloads after 4zx: 4zx's frontier model served with request tracing
# and both SLOs, OBS_SERVE_REQUESTS HTTP requests beside the same engine
# without tracing
OBS_LEVELS = ("none", "basic", "full")
# the frontier runs' order: each level twice, in turns (ABCCBA)
OBS_TURNS = OBS_LEVELS + OBS_LEVELS[::-1]
OBS_ROUNDS, OBS_F64_ROUNDS, OBS_PROFILED = 10, 5, 3
OBS_NAN_ROWS, OBS_NAN_AT, OBS_NAN_ROUNDS = 200_000, 2, 5
OBS_SERVE_REQUESTS = 300
OBS_SERVE_SIZES = (1, 16, 256)
SERVE_MODEL = "serve_binary.model.txt"    # 4zx's frontier model, in tmp


def profiled_block(bst, rounds: int = OBS_PROFILED) -> dict:
    """``rounds`` more iterations of ``bst`` through ``train_many`` (the
    fused loop, in blocks at basic) under torch.profiler: CUDA kernel
    launches and synchronisations an iteration, counted as
    ``iteration_counts`` counts them."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        bst._impl.train_many(rounds)
        torch.cuda.synchronize()
    events = collections.Counter(
        e.name() for e in prof.profiler.kineto_results.events())
    return {"launches_per_iter": sum(events[n] for n in (
                "cudaLaunchKernel", "cuLaunchKernel",
                "cudaLaunchKernelExC")) / rounds,
            "syncs_per_iter": sum(events[n] for n in (
                "cudaStreamSynchronize", "cudaDeviceSynchronize")) / rounds}


def frontier_waves(models) -> int:
    """The slot-kernel passes frontier growth makes for ``models``: one a
    wave, and a tree of depth d takes d waves (``node_waves``)."""
    return sum(int(node_waves(t, int(t.num_leaves_actual) - 1).max()) + 1
               for t in models if t.num_leaves_actual > 1)


def nan_gradients_at(bst, at: int) -> list:
    """Make ``bst``'s objective return NaN gradients (one row in seven) at
    iteration ``at`` of the fused loop; returns the list of iterations
    whose gradients it computed."""
    impl = bst._impl
    real = impl.objective.get_gradients
    calls = []

    def poisoned(scores):
        grad, hess = real(scores)
        if len(calls) == at:
            grad = grad.clone()
            grad[::7] = float("nan")
        calls.append(len(calls))
        return grad, hess
    impl.objective.get_gradients = poisoned
    return calls


def nan_fobj(at: int, calls: list):
    """The logistic objective (``logistic_fobj``) with NaN gradients, one
    row in seven, at its call ``at``."""
    def fobj(preds, train_data):
        grad, hess = logistic_fobj(preds, train_data)
        if len(calls) == at:
            grad = np.array(grad, np.float32)
            grad[::7] = np.nan
        calls.append(len(calls))
        return grad, hess
    return fobj


def events_of(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def drive_nan_paths(x, y, tmp: str) -> dict:
    """4zzh's NaN gradients at iteration OBS_NAN_AT on OBS_NAN_ROWS rows,
    frontier: under full with ``health_monitor=raise`` a custom objective's
    NaN raises at that iteration (its iteration events end there); under
    basic the fused loop's NaN raises after the block's one fetch (the
    stump ends the block: the port stops at a tree with no split, as
    LightGBM does); with ``warn`` the run goes on to that stop, not
    aborted; each raise leaves a flight-recorder dump that names it."""
    xs, ys = x[:OBS_NAN_ROWS], y[:OBS_NAN_ROWS]
    base = dict(PARAMS, **GROWTH_PARAMS["frontier"], obs_flight_recorder=64)
    out = {}
    for level, action in (("full", "raise"), ("basic", "raise"),
                          ("basic", "warn")):
        label = "%s %s" % (level, action)
        ev = os.path.join(tmp, "nan_%s_%s.jsonl" % (level, action))
        params = dict(base, observability=level, health_monitor=action,
                      obs_event_file=ev)
        ds = lgb.Dataset(xs, label=ys, params=params)
        err, calls, bst = None, [], None
        try:
            if level == "full":
                bst = lgb.train(params, ds, OBS_NAN_ROUNDS,
                                fobj=nan_fobj(OBS_NAN_AT, calls))
            else:
                # the fused loop as engine.train runs it, its objective
                # poisoned
                bst = lgb.Booster(params=params, train_set=ds)
                calls = nan_gradients_at(bst, OBS_NAN_AT)
                try:
                    bst._impl.train_many(OBS_NAN_ROUNDS)
                finally:
                    bst._impl.obs.release()
        except port_gbdt.LightGBMError as e:
            err = e
        records = events_of(ev)
        dispatch = [(r["event"], r["iteration"], r["count"]) for r in records
                    if r["event"] in ("iteration", "block")]
        health = [(r["iteration"], r["kind"]) for r in records
                  if r["event"] == "health"]
        dump = ev + ".0.crash.jsonl"
        reason = (events_of(dump)[0]["reason"] if os.path.exists(dump)
                  else None)
        log("path 4zzh NaN %s: the objective ran iterations %s, dispatch "
            "events %s, health %s, raised %r, flight dump %s"
            % (label, calls, dispatch, health, str(err) if err else None,
               reason))
        want_health = [(OBS_NAN_AT, "zero_gain_wave"),
                       (OBS_NAN_AT, "nonfinite_gradient")]
        if calls != list(range(OBS_NAN_AT + 1)) or health != want_health:
            raise AssertionError("4zzh NaN %s: calls %s, health %s"
                                 % (label, calls, health))
        if action == "raise":
            want_dispatch = ([("iteration", i, 1)
                              for i in range(OBS_NAN_AT + 1)]
                             if level == "full"
                             else [("block", 0, OBS_NAN_AT + 1)])
            said = "non-finite gradient/hessian at iteration %d" % OBS_NAN_AT
            if err is None or said not in str(err) \
                    or dispatch != want_dispatch:
                raise AssertionError("4zzh NaN %s: raised %r after %s"
                                     % (label, err, dispatch))
            if reason != "health:nonfinite_gradient":
                raise AssertionError("4zzh NaN %s: flight dump %r"
                                     % (label, reason))
        else:
            anomalies = bst._impl.obs.monitor.anomaly_count()
            if err is not None or anomalies < 1 \
                    or bst.current_iteration() != OBS_NAN_AT:
                raise AssertionError("4zzh NaN warn: raised %r, %d "
                                     "anomalies, %d iterations kept"
                                     % (err, anomalies,
                                        bst.current_iteration()))
        out[label] = {"calls": calls, "dispatch": dispatch,
                      "raised": str(err) if err else None,
                      "flight_dump_reason": reason}
    return out


def drive_observability_path(ds, x, y, tmp: str) -> dict:
    """Path 4zzh: training observability on 4b's data ``ds`` (``x``,
    ``y``): frontier at each of OBS_LEVELS in turns, OBS_ROUNDS rounds,
    with the launch counts set to 0 just before and read just after (the
    kernels' launches those the trees' waves need at every level, and
    ``none``'s where the trees are ``none``'s; the trees ``none``'s under
    WAVE_PARTING), then OBS_PROFILED more iterations of each under the
    profiler for launches and syncs an iteration; then exact f64 at full
    with the event file, the stats port, model statistics, the flight
    recorder, a 2-iteration Perfetto window and a throughput SLO, while a
    thread scrapes ``/metrics`` (the model text's trees equal the none
    run's byte for byte; ``/roofline``'s shares at most 1; the Chrome
    trace names the histogram kernel; one ``iteration`` record an
    iteration; ``ModelStats.importance`` equal to ``feature_importance``);
    then the NaN paths (``drive_nan_paths``)."""
    import threading
    import urllib.request
    from lightgbm_tpu_torch.obs.costmodel import get_cost_model
    out = {"frontier": {}}
    # ---- exact f64 at full, every training telemetry option ------------
    f64 = dict(CKPT_PARAMS)
    # the cost model's entries and the train_iter spans are this run's:
    # the first at full in this process, the model cleared just before
    get_cost_model().clear()
    ev = os.path.join(tmp, "obs_events.jsonl")
    perfetto_dir = os.path.join(tmp, "obs_perfetto")
    full = dict(f64, observability="full", obs_event_file=ev,
                obs_stats_port=0, obs_modelstats=True,
                obs_flight_recorder=256, obs_perfetto_dir=perfetto_dir,
                obs_perfetto_start=1, obs_perfetto_iters=2,
                train_slo_rows_per_sec=1.0)
    ref, ref_s, ref_launches, _ = train_counted(f64, ds,
                                                rounds=OBS_F64_ROUNDS)
    seen, port_box, stop = [], {}, threading.Event()

    def scraper():
        while not stop.is_set():
            port = port_box.get("port")
            if port is not None:
                text = urllib.request.urlopen(
                    "http://127.0.0.1:%d/metrics" % port,
                    timeout=30).read().decode()
                for line in text.splitlines():
                    if line.startswith("lgbm_train_iterations_total "):
                        seen.append(float(line.split()[1]))
            stop.wait(0.05)

    def note_port(env):
        port_box.setdefault("port", env.model._impl.obs.stats.port)
    note_port.order = 1
    thread = threading.Thread(target=scraper, daemon=True)
    thread.start()
    try:
        bst, full_s, full_launches, _ = train_counted(
            full, ds, rounds=OBS_F64_ROUNDS, callbacks=[note_port])
        time.sleep(0.2)
    finally:
        stop.set()
        thread.join(timeout=30)
    obs = bst._impl.obs
    try:
        roof = json.loads(urllib.request.urlopen(
            "http://127.0.0.1:%d/roofline" % obs.stats.port,
            timeout=30).read())
        slo = json.loads(urllib.request.urlopen(
            "http://127.0.0.1:%d/slo" % obs.stats.port, timeout=30).read())
    finally:
        obs.stats.stop()
    same_text = model_trees(bst.model_to_string()) == \
        model_trees(ref.model_to_string())
    shares = {r["phase"]: {k: r.get(k) for k in ("calls", "seconds",
                                                   "bytes_per_call",
                                                   "bytes_per_s",
                                                   "membw_util", "mfu")}
              for r in roof["rows"]}
    over = [p for p, r in shares.items()
            if (r["membw_util"] or 0) > 1.0 or (r["mfu"] or 0) > 1.0]
    records = events_of(ev)
    iters = [r["iteration"] for r in records if r["event"] == "iteration"]
    (trace_file,) = os.listdir(perfetto_dir)
    trace_path = os.path.join(perfetto_dir, trace_file)
    trace_mb = os.path.getsize(trace_path) / 2 ** 20
    with open(trace_path) as f:
        # the event names, read without building the trace's objects
        names = set(re.findall(r'"name":\s*"([^"]*)"', f.read()))
    hist_kernels = sorted(n for n in names if "hist_" in n and "kernel" in n)
    stats = bst._impl._modelstats
    importance_equal = all(
        np.array_equal(stats.importance(kind), bst.feature_importance(kind))
        for kind in ("split", "gain"))
    rising = len(set(seen)) >= 2 and seen == sorted(seen)
    log("path 4zzh exact f64 on %s: none %.3f s, full %.3f s per iteration "
        "(%d rounds); launches none %s, full %s; model text's trees equal "
        "none's: %s; /metrics scraped %d times during training, "
        "lgbm_train_iterations_total %s; /roofline on %s, peaks %s: %s; "
        "/slo %s; Chrome trace %s (%.1f MB, %d names), the histogram "
        "kernels in it %s; iteration records %s; importance equal to "
        "feature_importance: %s" % (
            card_line(), ref_s / OBS_F64_ROUNDS, full_s / OBS_F64_ROUNDS,
            OBS_F64_ROUNDS, {k: v for k, v in ref_launches.items() if v},
            {k: v for k, v in full_launches.items() if v}, same_text,
            len(seen), sorted(set(seen)), roof["device_kind"],
            roof["peaks"], shares, sorted(slo["slos"]), trace_file,
            trace_mb, len(names), hist_kernels[:4], iters,
            importance_equal))
    if not same_text:
        raise AssertionError("4zzh: the full run's trees differ from none's")
    if not rising:
        raise AssertionError("4zzh: /metrics showed iterations %s" % seen)
    if over or not shares or roof["peaks"] is None:
        raise AssertionError("4zzh: /roofline shares %s (peaks %s)"
                             % (shares, roof["peaks"]))
    if not hist_kernels or "train_iter" not in names:
        raise AssertionError("4zzh: the Chrome trace names no histogram "
                             "kernel or no train_iter")
    if iters != list(range(OBS_F64_ROUNDS)):
        raise AssertionError("4zzh: iteration records %s" % iters)
    if not importance_equal:
        raise AssertionError("4zzh: ModelStats.importance differs from "
                             "feature_importance")
    out["exact_f64"] = {"none_s_per_iter": ref_s / OBS_F64_ROUNDS,
                        "full_s_per_iter": full_s / OBS_F64_ROUNDS,
                        "scraped": sorted(set(seen)), "roofline": shares,
                        "peaks": roof["peaks"], "slo": sorted(slo["slos"]),
                        "trace_kernels": hist_kernels, "trace_mb": trace_mb}

    # ---- frontier at each level, in turns -------------------------------
    params = dict(PARAMS, **GROWTH_PARAMS["frontier"])
    runs, turns = {}, []
    for level in OBS_TURNS:
        bst, train_s, launches, _ = train_counted(
            dict(params, observability=level), ds, rounds=OBS_ROUNDS)
        turns.append(launches)
        waves = frontier_waves(bst.models)
        if launches["build_histogram_cuda"] != len(bst.models) \
                or launches["build_histogram_slots_cuda"] != waves:
            raise AssertionError("4zzh %s: launches %s for %d trees of %d "
                                 "waves" % (level, launches, len(bst.models),
                                            waves))
        if level in runs:      # the second turn: its time only
            out["frontier"][level]["s_per_iter"].append(train_s / OBS_ROUNDS)
            if level == "none":    # the control of the trees' comparison
                runs["none 2"] = (bst, launches)
                out["frontier"]["none"]["control_auc"] = auc(
                    bst.predict(x, raw_score=True), y)
            continue
        runs[level] = (bst, launches)
        out["frontier"][level] = {
            "s_per_iter": [train_s / OBS_ROUNDS], "launches": launches,
            "waves": waves, "auc": auc(bst.predict(x, raw_score=True), y)}
    # the card's f32 sums do not repeat, so two runs of one level may part
    # at a gain tie (as 4zzb's resume and phase 5 may): the first tree that
    # differs must part within the frontier rule, and the trees after it grow on
    # other scores (regrow_gain_rel 0: no tree of more substituted splits
    # is let through), from where the forests are held to their AUC.
    # none's second turn against its first is the control
    rows = torch.as_tensor(x, dtype=torch.float64, device="cuda")
    none_bst = runs["none"][0]
    for level in OBS_LEVELS:
        bst, launches = runs[level] if level != "none" else runs["none 2"]
        res = out["frontier"][level]
        res["ties"] = held_to("4zzh %s" % level, bst, none_bst.models,
                              "none", rows,
                              res["control_auc" if level == "none"
                                  else "auc"],
                              out["frontier"]["none"]["auc"],
                              regrow_gain_rel=0.0)
        if not res["ties"] and launches != runs["none"][1]:
            raise AssertionError("4zzh %s: the trees are none's, the "
                                 "launches %s against %s"
                                 % (level, launches, runs["none"][1]))
    del rows
    for level in OBS_LEVELS:
        res = out["frontier"][level]
        res.update(profiled_block(runs[level][0]))
        log("path 4zzh frontier %s on %s: %s s per iteration over %d rounds "
            "(two turns), launches %s (%d waves), train AUC %.6f; %d more "
            "iterations under the profiler: %.1f CUDA launches and %.2f "
            "syncs an iteration" % (
                level, card_line(),
                ", ".join("%.4f" % v for v in res["s_per_iter"]), OBS_ROUNDS,
                {k: v for k, v in res["launches"].items() if v},
                res["waves"], res["auc"], OBS_PROFILED,
                res["launches_per_iter"], res["syncs_per_iter"]))
    del runs, none_bst, bst
    launches_total = sum_counts(*turns)
    out["nan"] = drive_nan_paths(x, y, tmp)

    out["launches"] = sum_counts(launches_total, ref_launches, full_launches)
    return out


def drive_traced_serving_path(tmp: str, dev) -> dict:
    """Path 4zzi: 4zx's frontier model (SERVE_MODEL in ``tmp``) served
    through HTTP by two apps on the card, one with ``obs_trace=true``,
    ``obs_trace_sample=1.0``, ``serve_slo_p99_ms`` and
    ``serve_slo_availability``, one without; OBS_SERVE_REQUESTS requests
    of OBS_SERVE_SIZES rows to each in turns, the traced ones with an
    ``x-lgbm-trace`` header: every response ``predict``'s bit for bit,
    every trace kept under its inbound ID as a full tree (request,
    queue_wait, batch, predict, device_dispatch, device_wait) in the
    event file and the newest in ``/traces``, no graph captured after
    warmup, ``/slo`` answering; p50/p99 of each app."""
    import threading
    import urllib.request
    from lightgbm_tpu_torch import serving
    from lightgbm_tpu_torch.obs.reqtrace import TRACE_HEADER
    path = os.path.join(tmp, SERVE_MODEL)
    bst = lgb.Booster(model_file=path)
    rows = bench_data(SERVE_ROWS, seed=1)[0]
    want = bst.predict(rows)
    ev = os.path.join(tmp, "serve_traces.jsonl")
    apps, servers = {}, []
    try:
        for name, extra in (("traced", {
                "obs_trace": True, "obs_trace_sample": 1.0,
                "obs_trace_slow_ms": 1e9, "obs_event_file": ev,
                "serve_slo_p99_ms": 50.0, "serve_slo_availability": 0.999}),
                ("plain", {})):
            app = serving.build_app(Config(dict(extra, input_model=path)))
            app.engine.warmup()
            srv = serving.make_server(app, "127.0.0.1", 0)
            threading.Thread(target=srv.serve_forever, daemon=True).start()
            servers.append(srv)
            apps[name] = (app, srv.server_address[1])
        c0 = serving.backend_compile_count()
        lat = {"traced": [], "plain": []}
        sent = []
        for i in range(OBS_SERVE_REQUESTS):
            n = OBS_SERVE_SIZES[i % len(OBS_SERVE_SIZES)]
            lo = (i * 997) % (SERVE_ROWS - n + 1)
            body = json.dumps({"model": "default",
                               "data": rows[lo:lo + n].tolist()}).encode()
            for name in ("traced", "plain"):
                headers = {}
                if name == "traced":
                    tid = "%016x" % (0x4a11 * 1_000_003 + i)
                    headers[TRACE_HEADER] = tid + "-00ab"
                    sent.append(tid)
                t0 = time.perf_counter()
                rep = json.loads(urllib.request.urlopen(
                    urllib.request.Request(
                        "http://127.0.0.1:%d/predict" % apps[name][1],
                        data=body, headers=headers), timeout=120).read())
                lat[name].append((time.perf_counter() - t0) * 1e3)
                require_equal(rep["predictions"], want[lo:lo + n],
                              "4zzi %s %d rows" % (name, n))
        # the process-wide count after both engines' warmups (each
        # engine's own floor would read the other's warmup as its own)
        captures = serving.backend_compile_count() - c0

        def get(path_):
            return json.loads(urllib.request.urlopen(
                "http://127.0.0.1:%d%s" % (apps["traced"][1], path_),
                timeout=60).read())
        recent = get("/traces")["traces"]
        slo = get("/slo")
    finally:
        for srv in servers:
            srv.shutdown()
            srv.server_close()
        for app, _ in apps.values():
            app.close()
    trees = {}
    for r in events_of(ev):
        if r["event"] == "span":
            trees.setdefault(r["trace"], []).append(r)
    want_names = ["batch", "device_dispatch", "device_wait", "predict",
                  "queue_wait", "request"]
    broken = [t for t in sent
              if sorted(s["name"] for s in trees.get(t, ())) != want_names
              or not any(s["name"] == "request" and s["parent"] == "00ab"
                         for s in trees[t])]
    summary = {name: serving.latency_summary(v) for name, v in lat.items()}
    log("path 4zzi on %s: %d requests of %s rows to each app, all equal to "
        "predict; traced p50 %.3f ms p99 %.3f ms, untraced p50 %.3f ms p99 "
        "%.3f ms; %d traces in the event file (%d not a full tree), the "
        "newest %d in /traces; graphs captured after warmup %d; /slo %s"
        % (card_line(), OBS_SERVE_REQUESTS, OBS_SERVE_SIZES,
           summary["traced"]["p50_ms"], summary["traced"]["p99_ms"],
           summary["plain"]["p50_ms"], summary["plain"]["p99_ms"],
           len(trees), len(broken), len(recent), captures,
           {k: (v["burning"], v["observed"])
            for k, v in slo["slos"].items()}))
    if broken or len(trees) != len(sent):
        raise AssertionError("4zzi: %d of %d traces are not full trees"
                             % (len(broken), len(sent)))
    if [t["trace"] for t in recent] != sent[-len(recent):] or not recent:
        raise AssertionError("4zzi: /traces holds %s"
                             % [t["trace"] for t in recent][:5])
    if captures:
        raise AssertionError("4zzi: %d graphs captured after warmup"
                             % captures)
    if sorted(slo["slos"]) != ["serve_availability", "serve_p99"]:
        raise AssertionError("4zzi: /slo answered %s" % slo)
    return {"launches": {name: 0 for name in read_counts()},
            "requests": OBS_SERVE_REQUESTS, "latency_ms": summary,
            "traces": len(trees), "recent": len(recent),
            "captures_after_warmup": captures,
            "slo": {k: v["burning"] for k, v in slo["slos"].items()}}


# ---- 4zzj. distributed learners (#13 slice a, #14) ----------------------
# two rank processes of this script (``--dist-rank R``) on cuda:0, each
# loading the whole of 4a's data and keeping its row block, joined in a
# torch.distributed group over gloo (two ranks on one card are not NCCL's,
# scripts/nccl_two_ranks.py: the group's rule takes gloo). Each run trains
# NUM_ITERS rounds on 4a's parameters; its label,
# its options over PARAMS, the learner it must take, and what it is held
# to (the single-process trees of ``refs`` and a train AUC)
DIST_RANKS = 2
DIST_TIMEOUT_S = 480
DIST_RUNS = {
    "a": (dict(GROWTH_PARAMS["exact"], tree_learner="data",
               gpu_use_dp=True), "psum"),
    "b_rs": (dict(GROWTH_PARAMS["frontier"], tree_learner="data",
                  tpu_frontier_rs=True), "data_rs"),
    "b_psum": (dict(GROWTH_PARAMS["frontier"], tree_learner="data",
                    tpu_frontier_rs=False), "psum"),
    "b_voting": (dict(GROWTH_PARAMS["frontier"], tree_learner="voting",
                      top_k=NUM_FEATURES), "voting"),
    "c": (dict(GROWTH_PARAMS["frontier"], tree_learner="voting", top_k=3,
               metric="binary_logloss"), "voting"),
    "d": (dict(GROWTH_PARAMS["exact"], tree_learner="feature"), "feature"),
    "e": (dict(GROWTH_PARAMS["batched_part"], tree_learner="data"), "psum"),
}
# each run's single-process reference: trees (``refs``), JAX AUC, and the
# single-process path whose s/iter it is set against
DIST_REFERENCE = {
    "a": ("4zza", JAX_F64_METRIC["4zn"]["auc"], F64_AUC_TOL),
    "b_rs": ("frontier", JAX_REFERENCE_AUC["frontier"], AUC_TOLERANCE),
    "b_psum": ("frontier", JAX_REFERENCE_AUC["frontier"], AUC_TOLERANCE),
    "b_voting": ("frontier", JAX_REFERENCE_AUC["frontier"], AUC_TOLERANCE),
    "c": ("frontier", None, None),
    "d": ("exact", JAX_REFERENCE_AUC["exact"], AUC_TOLERANCE),
    "e": ("batched_part", JAX_REFERENCE_AUC["batched_part"], AUC_TOLERANCE),
}
DIST_KERNELS = {
    "a": ("build_histogram_f64_cuda",),
    "b_rs": PATH_KERNELS["frontier"], "b_psum": PATH_KERNELS["frontier"],
    "b_voting": PATH_KERNELS["frontier"], "c": PATH_KERNELS["frontier"],
    "d": PATH_KERNELS["exact"], "e": PATH_KERNELS["batched_part"],
}
# (c), PV-Tree with top_k=3, is held to the JAX package's documented
# approximation (tests/test_parallel_learners.py:198-234): its train
# logloss never rises by more than this, and ends within this share of the
# single-process run's drop of it
VOTING_RISE_TOL, VOTING_DROP_REL = 1e-6, 0.1


def binary_logloss(y: np.ndarray, p: np.ndarray) -> float:
    p = np.clip(np.asarray(p, np.float64), 1e-15, 1 - 1e-15)
    return float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))


def reference_forests(models: dict, x, y) -> dict:
    """4zzj's single-process references from phase 4's boosters: the first
    NUM_ITERS trees of 4a, 4b and 4d (each booster has one more, from its
    profiled iteration), and 4b's train logloss after each iteration."""
    import copy
    refs = {g: copy.deepcopy(models[g].models[:NUM_ITERS])
            for g in ("exact", "frontier", "batched_part")}
    refs["frontier_logloss"] = [
        binary_logloss(y, models["frontier"].predict(x, num_iteration=i))
        for i in range(1, NUM_ITERS + 1)]
    return refs


def run_dist_rank(argv) -> int:
    """``--dist-rank R --dir D --port P``: rank R of 4zzj. Loads the whole
    of 4a's data, then trains each of DIST_RUNS in a group of DIST_RANKS
    processes (``num_machines``, ``machines`` with the rendezvous at
    127.0.0.1:P, the rank from ``LIGHTGBM_TPU_RANK``), each run's launch
    counts set to 0 just before and read just after; writes each run's
    result to D/rank_R.json and rank 0 each run's trees to D/trees_L.pkl."""
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("rank", type=int)
    parser.add_argument("--dir", required=True)
    parser.add_argument("--port", type=int, required=True)
    args = parser.parse_args(argv)
    global LOG_PREFIX
    LOG_PREFIX = "[4zzj rank %d] " % args.rank
    os.environ["LIGHTGBM_TPU_RANK"] = str(args.rank)
    torch.set_num_threads(2)
    x, y = bench_data(MAIN_ROWS)
    t0 = time.perf_counter()
    ds = lgb.Dataset(x, label=y, params=PARAMS).construct()
    log("binning: %.2f s for %d x %d" % (time.perf_counter() - t0,
                                         *x.shape))
    from lightgbm_tpu_torch.parallel import network
    machines = "127.0.0.1:%d,127.0.0.1:0" % args.port
    out = {}
    for label, (extra, _) in DIST_RUNS.items():
        params = dict(PARAMS, **extra, num_machines=DIST_RANKS,
                      machines=machines)
        kw = {"valid_sets": [ds], "evals_result": {},
              "verbose_eval": False} if label == "c" else {}
        if network.group() is not None:
            network.group().counter.reset()
        bst, train_s, launches, steps = train_counted(params, ds, **kw)
        impl = bst._impl
        comm = impl._comm
        res = {"train_s": train_s, "s_per_iter": train_s / NUM_ITERS,
               "launches": launches, "steps": steps,
               "learner": impl._dist.kind if impl._dist else None,
               "world": comm.world, "num_data": impl.num_data,
               "backend": comm.backend, "digests": bst.model_digests,
               "counter": comm.counter.summary(),
               "splits": int(sum(t.num_leaves_actual - 1
                                 for t in bst.models)),
               "auc": auc(bst.predict(x), y)}
        if label == "c":
            # the training set is valid set 0 here (named valid_0)
            res["logloss"] = next(iter(kw["evals_result"].values()))[
                "binary_logloss"]
        if args.rank == 0:
            with open(os.path.join(args.dir, "trees_%s.pkl" % label),
                      "wb") as f:
                pickle.dump(bst.models, f)
        log("run %s: %.3f s per iteration, AUC %.6f, learner %s over %s, "
            "%d collectives, %.1f ms in them"
            % (label, res["s_per_iter"], res["auc"], res["learner"],
               res["backend"], sum(res["counter"]["calls"].values()),
               res["counter"]["seconds"] * 1e3))
        out[label] = res
        del bst
    network.free()
    with open(os.path.join(args.dir, "rank_%d.json" % args.rank), "w") as f:
        json.dump(out, f)
    return 0


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(flag: str, directory: str, timeout_s: float) -> list:
    """Start DIST_RANKS processes of this script with ``flag R --dir
    directory --port P`` and wait for them; returns their exit codes, None
    for one still running at ``timeout_s`` (then killed)."""
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag, str(r), "--dir",
         directory, "--port", str(port)], env=env)
        for r in range(DIST_RANKS)]
    t0 = time.perf_counter()
    rcs = []
    try:
        for p in procs:
            try:
                rcs.append(p.wait(timeout=max(
                    timeout_s - (time.perf_counter() - t0), 1.0)))
            except subprocess.TimeoutExpired:
                rcs.append(None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return rcs


def drive_distributed_path(x, y, refs: dict, paths: dict, tmp: str) -> dict:
    """Path 4zzj: the runs of DIST_RUNS in two rank processes over gloo,
    each checked: both ranks' model digests equal, the learner, the transport,
    the path's kernels launched on both ranks; (a) node for node with
    4zza's single-process float64 trees (a tie under phase 5's rule the one
    exception), its AUC within F64_AUC_TOL of the 4zn constant; (b) and
    (d)-(e) held to the single-process trees under phase 5's frontier rule
    and their AUC within AUC_TOLERANCE of the JAX constants; (c) the
    documented PV-Tree approximation. Prints the s/iter at two ranks
    against one, the all-reduce ms a split, the payload a wave and the
    transport."""
    directory = os.path.join(tmp, "dist_4zzj")
    os.mkdir(directory)
    rcs = run_ranks("--dist-rank", directory, DIST_TIMEOUT_S)
    if rcs != [0] * DIST_RANKS:
        raise AssertionError("4zzj: the rank processes exited %s (None: "
                             "still running at %d s)" % (rcs, DIST_TIMEOUT_S))
    ranks = []
    for r in range(DIST_RANKS):
        with open(os.path.join(directory, "rank_%d.json" % r)) as f:
            ranks.append(json.load(f))
    rows = torch.as_tensor(x, dtype=torch.float64, device="cuda")
    launches = {w.__name__: 0 for w in COUNTED}
    out = {"runs": {}}
    for label, (extra, learner) in DIST_RUNS.items():
        runs = [rk[label] for rk in ranks]
        ref_name, want_auc, auc_tol = DIST_REFERENCE[label]
        for rk, res in enumerate(runs):
            if res["learner"] != learner or res["world"] != DIST_RANKS \
                    or res["backend"] != "gloo":
                raise AssertionError(
                    "4zzj %s rank %d: learner %s over %d ranks (%s)"
                    % (label, rk, res["learner"], res["world"],
                       res["backend"]))
            if len(set(res["digests"])) != 1 \
                    or res["digests"] != runs[0]["digests"]:
                raise AssertionError("4zzj %s: the ranks' model digests "
                                     "differ: %s" % (label, res["digests"]))
            for name in DIST_KERNELS[label]:
                if res["launches"][name] <= 0:
                    raise AssertionError("4zzj %s rank %d never launched %s"
                                         % (label, rk, name))
            for name, n in res["launches"].items():
                launches[name] += n
        with open(os.path.join(directory, "trees_%s.pkl" % label),
                  "rb") as f:
            trees = pickle.load(f)
        got_auc = runs[0]["auc"]
        ties = []
        if label == "c":
            lv, ls = runs[0]["logloss"], refs["frontier_logloss"]
            if not (all(b <= a + VOTING_RISE_TOL for a, b in zip(lv, lv[1:]))
                    and abs(lv[-1] - ls[-1])
                    < VOTING_DROP_REL * (ls[0] - ls[-1])):
                raise AssertionError(
                    "4zzj c: voting top_k=3 logloss %s against the single "
                    "process's %s" % (lv, ls))
        else:
            trees_match(trees, refs[ref_name], ties, WAVE_PARTING, None,
                        rows)
            if label == "a" and ties and ties[0]["parting_tie"] is None:
                # float64 sums leave no f32 tie: only a located one
                raise AssertionError("4zzj a: the trees differ from 4zza's "
                                     "without a tie under phase 5's rule")
            if abs(got_auc - want_auc) > auc_tol:
                raise AssertionError("4zzj %s: AUC %.10f is more than %g "
                                     "from %.10f" % (label, got_auc,
                                                     auc_tol, want_auc))
        one = (paths["4zza"]["s_per_iter_no_ckpt"] if label == "a"
               else paths[ref_name]["s_per_iter"])
        counter = runs[0]["counter"]
        reduce_s = counter["op_seconds"].get("all_reduce", 0.0)
        waves = counter["waves"]
        moved = counter["waves_moved"]
        res = {"s_per_iter": [rk["s_per_iter"] for rk in runs],
               "s_per_iter_one_process": one, "auc": got_auc,
               "learner": learner, "ties": len(ties),
               "parting_ties": sum(1 for t in ties
                                   if t["after_parting_tie"]),
               "splits": runs[0]["splits"],
               "all_reduce_ms_per_split": reduce_s * 1e3 / max(
                   runs[0]["splits"], 1),
               "collective_ms_per_split": counter["seconds"] * 1e3 / max(
                   runs[0]["splits"], 1),
               "collective_ms": counter["seconds"] * 1e3,
               "calls": counter["calls"], "payload": counter["payload"],
               "moved": counter["moved"],
               "payload_per_wave": (sum(waves) / len(waves)
                                    if waves else None),
               "moved_per_wave": (sum(moved) / len(moved)
                                  if moved else None),
               "staged": counter["staged"],
               "emulated_rs": counter["emulated_rs"],
               "transport": runs[0]["backend"]}
        if label == "c":
            res["logloss"] = runs[0]["logloss"]
        out["runs"][label] = res
        log("path 4zzj %s (%s): %.3f s per iteration at 2 ranks (%s) "
            "against %.3f at 1; AUC %.10f; %d trees like the single "
            "process's but %d (%d at a parting tie); all-reduce %.3f ms a "
            "split, collectives %.3f ms a split (%d splits), %.1f ms in %s "
            "collectives; payload %s floats (transport received %s)%s; "
            "transport %s (%d staged "
            "through host memory, %d reduce-scatters as all-reduces)"
            % (label, learner, max(res["s_per_iter"]),
               ", ".join("%.3f" % s for s in res["s_per_iter"]), one,
               got_auc, NUM_ITERS, res["ties"], res["parting_ties"],
               res["all_reduce_ms_per_split"],
               res["collective_ms_per_split"], res["splits"],
               res["collective_ms"], counter["calls"], counter["payload"],
               counter["moved"],
               "" if not waves else
               ", %.0f a wave by the JAX package's rule, %.0f received, "
               "over %d waves" % (res["payload_per_wave"],
                                  res["moved_per_wave"], len(waves)),
               res["transport"], res["staged"], res["emulated_rs"]))
    out["launches"] = launches
    out["serial_logloss"] = refs["frontier_logloss"]
    return out


def kernel_entry(name, source, replaces, launches, rows, headline):
    """One kernel of the ``kernels`` line: its headline shape's times and
    every shape it was checked at."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": headline["ms"], "plain_ms": headline["plain_ms"],
            "bound_ms": headline["bound_ms"],
            "bound_by": headline["bound_by"],
            "library_ms": headline["library_ms"], "shapes": rows}


# phases 4-5 from 4q on run in this process and in one more process of
# this script for each of PARTS (the module docstring), which must end
# PART_TIMEOUT_S into the run; each part's torch and OpenMP take
# PART_THREADS of the host's cores
PARTS = ("workloads", "compare")
PART_TIMEOUT_S = 1_150
PART_THREADS = 3


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script only runs on a GPU",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--ckpt-child"]:
        return run_ckpt_child(sys.argv[2:])
    if sys.argv[1:2] == ["--fleet-replica"]:
        return run_fleet_replica(sys.argv[2:])
    if sys.argv[1:2] == ["--dist-rank"]:
        return run_dist_rank(sys.argv[2:])
    if len(sys.argv) > 1:
        return run_part(sys.argv[1:])
    with tempfile.TemporaryDirectory() as tmp:
        return run(tmp)


def start_parts(dense: dict, tmp: str, t_start: float) -> dict:
    """Start a process of this script for each of PARTS, each in a
    directory of its own under ``tmp``, given the dense paths ``dense``
    and the run's start ``t_start`` (``time.perf_counter`` is the host's
    monotonic clock, shared by its processes). Returns {part: (process,
    its directory)}."""
    dense_file = os.path.join(tmp, "dense_paths.json")
    with open(dense_file, "w") as f:
        json.dump(dense, f)
    env = dict(os.environ, OMP_NUM_THREADS=str(PART_THREADS))
    procs = {}
    for name in PARTS:
        directory = os.path.join(tmp, "part_" + name)
        os.mkdir(directory)
        procs[name] = (subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--part", name,
             "--dense", dense_file, "--dir", directory,
             "--t0", repr(t_start)], env=env), directory)
    return procs


def check_parts(procs: dict) -> None:
    """Raise if a part has already failed."""
    for name, (proc, _) in procs.items():
        if proc.poll() not in (None, 0):
            raise AssertionError("part %s exited %d" % (name, proc.returncode))


def join_parts(procs: dict, t_start: float) -> dict:
    """{part: its result} once every part has ended; raises if one fails or
    is still running PART_TIMEOUT_S after ``t_start``."""
    results = {}
    for name, (proc, directory) in procs.items():
        left = PART_TIMEOUT_S - (time.perf_counter() - t_start)
        try:
            rc = proc.wait(timeout=max(left, 1.0))
        except subprocess.TimeoutExpired:
            raise AssertionError("part %s was still running %d s into the "
                                 "run" % (name, PART_TIMEOUT_S)) from None
        if rc != 0:
            raise AssertionError("part %s exited %d" % (name, rc))
        with open(os.path.join(directory, "result.json")) as f:
            results[name] = json.load(f)
    return results


def stop_parts(procs: dict) -> None:
    """Kill every part still running, and reap them all."""
    for proc, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
        proc.wait()


def run_part(argv) -> int:
    """``--part NAME --dense FILE --dir DIR --t0 T``: part NAME's phases
    (``part_workloads`` or ``part_compare``) beside the dense paths in
    FILE, its result written to DIR/result.json."""
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--part", choices=PARTS, required=True)
    parser.add_argument("--dense", required=True)
    parser.add_argument("--dir", required=True)
    parser.add_argument("--t0", type=float, required=True)
    args = parser.parse_args(argv)
    global LOG_PREFIX
    LOG_PREFIX = "[%s] " % args.part
    torch.set_num_threads(PART_THREADS)
    with open(args.dense) as f:
        dense = json.load(f)
    part = {"workloads": part_workloads, "compare": part_compare}[args.part]
    result = part(dense, args.dir, args.t0)
    log_phase(args.t0, "the end of part %s" % args.part)
    with open(os.path.join(args.dir, "result.json"), "w") as f:
        json.dump(result, f)
    return 0


def dense_part(paths: dict, models: dict, extras: dict, ds, x, y, tmp: str,
               t_start: float, procs: dict, refs: dict) -> None:
    """This process's share of phase 4 after 4q, on bench.py's data ``x``,
    ``y`` binned as ``ds``: 4zb-4zf, 4zl-4zn, 4zq-4zs, 4zt-4zv, 4zza,
    4zzc and 4zzd, added to ``paths`` and ``extras``; between phases it
    raises if a part has failed (``check_parts``)."""
    log_phase(t_start, "4zb-4zf. row sampling on the same data")
    # ---- 4zb-4zf. row sampling on the same data ------------------------
    xv, yv = bench_data(VALID_ROWS, seed=1)
    valid = ds.create_valid(xv, label=yv).construct()
    for label, (growth, _, data, _, keeps_valid) in SAMPLING_PATHS.items():
        if data == "dense":
            paths[label] = drive_sampling_path(
                label, ds, x, y, paths[growth],
                (valid, xv) if keeps_valid else None)
    del valid
    check_parts(procs)

    log_phase(t_start, "4zl-4zm. forced splits and CEGB on the same data")
    # ---- 4zl-4zm. forced splits and CEGB on the same data --------------
    for label, (growth, kind) in CONSTRAINT_PATHS.items():
        if kind != "monotone":
            paths[label] = drive_constraint_path(label, ds, x, y,
                                                 paths[growth], tmp)

    log_phase(t_start, "4zn. float64 histograms on the same data")
    # ---- 4zn. float64 histograms on the same data ----------------------
    paths["4zn"] = drive_f64_path("4zn", ds, x, y, paths["exact"])
    check_parts(procs)

    log_phase(t_start, "4zq. sparse input, exact growth")
    # ---- 4zq. sparse input, exact growth -------------------------------
    x_sparse, y_sparse = sparse_data(MAIN_ROWS)
    paths["4zq"] = drive_sparse_path(x_sparse, y_sparse, paths["exact"],
                                     models)

    log_phase(t_start, "4zr. files and the binary cache")
    # ---- 4zr. files and the binary cache -------------------------------
    paths["4zr"] = drive_file_paths(x, y, ds, x_sparse, y_sparse, tmp)
    check_parts(procs)

    log_phase(t_start, "4zs. prediction extras of 4a and 4zq")
    # ---- 4zs. prediction extras of 4a and 4zq --------------------------
    extras["4a"] = drive_prediction_extras("4a", models.pop("exact"), x,
                                           leaves=True, early_stop=True)
    extras["4zq"] = drive_prediction_extras(
        "4zq", models.pop("4zq"), x_sparse,
        plain_rows=SPARSE_CONTRIB_PLAIN_ROWS)
    del x_sparse, y_sparse
    check_parts(procs)

    log_phase(t_start, "4zt. the scikit-learn estimators")
    # ---- 4zt-4zv. the Python surface ----------------------------------
    paths["4zt"] = drive_sklearn_path(x, y, xv, yv)
    check_parts(procs)
    log_phase(t_start, "4zu. cv")
    paths["4zu"] = drive_cv_path(x, y)
    check_parts(procs)
    log_phase(t_start, "4zv. the command line")
    paths["4zv"] = drive_cli_path(x, y, tmp)
    check_parts(procs)
    # ---- 4zza, 4zzc, 4zzd. checkpoints and resilience (#12, #18) -------
    paths.update(drive_checkpoint_paths(ds, x, y, tmp, t_start, refs))
    check_parts(procs)
    log_phase(t_start, "4zzj. distributed learners: two rank processes")
    # ---- 4zzj. distributed learners (#13 slice a, #14) ------------------
    paths["4zzj"] = drive_distributed_path(x, y, refs, paths, tmp)


def part_workloads(dense: dict, tmp: str, t_start: float) -> dict:
    """Part ``workloads``: the regression paths 4e-4h and 4zh-4zk, the
    bundled paths 4i-4l (their kernels first), the categorical paths 4m-4p
    (their root pass first) and 4zo, the multiclass paths 4r-4u, and the
    prediction extras of 4m and 4r, each beside the dense path of its
    growth mode in ``dense``, then the serving path 4zx with 4m's and 4r's
    boosters; ``tmp`` is the part's directory."""
    dev = torch.device("cuda", 0)
    paths, models, extras = dict(dense), {}, {}
    log_phase(t_start, "4e-4h. the regression workload")
    # ---- 4e-4h. the regression workload --------------------------------
    x, t = regression_data(MAIN_ROWS)
    xv, tv = regression_data(VALID_ROWS, seed=1)
    t0 = time.perf_counter()
    ds = lgb.Dataset(x, label=t, params=PARAMS).construct()
    valid = ds.create_valid(xv, label=tv).construct()
    log("binning: %.2f s for %d x %d and the valid set's %d rows"
        % (time.perf_counter() - t0, *x.shape, len(xv)))
    for label in REGRESSION_PATHS:
        paths[label] = drive_regression_path(label, ds, (valid, xv))

    log_phase(t_start, "4zh-4zk. monotone constraints on the same data")
    # ---- 4zh-4zk. monotone constraints on the same data ----------------
    for label, (growth, kind) in CONSTRAINT_PATHS.items():
        if kind == "monotone":
            paths[label] = drive_constraint_path(label, ds, x, t,
                                                 paths[growth], tmp)
    del ds, valid
    renewal = time_renewal(dev)

    log_phase(t_start, "4i-4l. the bundled workload, its kernels first")
    # ---- 4i-4l. the bundled workload, its kernels first ----------------
    x_bundled, y_bundled = bundled_data(MAIN_ROWS)
    xv, yv = bundled_data(VALID_ROWS, seed=1)
    t0 = time.perf_counter()
    ds = lgb.Dataset(x_bundled, label=y_bundled, params=PARAMS).construct()
    binning_s = time.perf_counter() - t0
    valid = ds.create_valid(xv, label=yv).construct()
    log("binning: %.2f s for %d x %d (%d stored columns, B=%d), the valid "
        "set's %d rows %.2f s more" % (binning_s, *x_bundled.shape,
                                       ds._binned.num_columns,
                                       ds._binned.max_col_bins(), len(xv),
                                       time.perf_counter() - t0 - binning_s))
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    bundled_rows = check_stored_kernels(dev, flush, ds._binned.X_binned,
                                        "bundled")
    del flush
    for label in BUNDLED_PATHS:
        paths[label] = drive_bundled_path(
            label, ds, x_bundled, y_bundled, (valid, xv) if label == "4i" else None)
        paths[label]["binning_s"] = binning_s
        log("path %s: %.3f s per iteration, binning %.2f s"
            % (label, paths[label]["s_per_iter"], binning_s))
    del ds, valid, x_bundled, y_bundled

    log_phase(t_start, "4m-4p. the categorical workload, its root pass first")
    # ---- 4m-4p. the categorical workload, its root pass first ----------
    x_cat, y_cat = categorical_data(MAIN_ROWS)
    xv, yv = categorical_data(VALID_ROWS, seed=1)
    t0 = time.perf_counter()
    ds = lgb.Dataset(x_cat, label=y_cat, params=PARAMS,
                     categorical_feature=CATEGORICAL_FEATURES).construct()
    binning_s = time.perf_counter() - t0
    valid = ds.create_valid(xv, label=yv).construct()
    mappers = [ds._binned.bin_mappers[j] for j in CATEGORICAL_FEATURES]
    log("binning: %.2f s for %d x %d (%d stored columns, B=%d; categorical "
        "bins %s, largest kept category %d), the valid set's %d rows %.2f "
        "s more" % (binning_s, *x_cat.shape, ds._binned.num_columns,
                    ds._binned.max_col_bins(), [m.num_bin for m in mappers],
                    max(max(m.bin_2_categorical) for m in mappers), len(xv),
                    time.perf_counter() - t0 - binning_s))
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    cat_rows = check_stored_kernels(dev, flush, ds._binned.X_binned,
                                    "categorical", root_only=True)
    del flush
    for label in CATEGORICAL_PATHS:
        paths[label] = drive_categorical_path(
            label, ds, x_cat, y_cat, (valid, xv) if label == "4m" else None,
            models)
        paths[label]["binning_s"] = binning_s
    log_phase(t_start, "4zo. float64 histograms on the categorical data")
    paths["4zo"] = drive_f64_path("4zo", ds, x_cat, y_cat, paths["4m"])
    paths["4zo"]["binning_s"] = binning_s
    largest = max(paths[label]["splits_on"]["max_category"]
                  for label in CATEGORICAL_PATHS)
    if largest < 256:
        raise AssertionError("no categorical path sent a category id of 256 "
                             "or more left (largest %d)" % largest)
    del ds, valid
    log_phase(t_start, "4zs. prediction extras of 4m")
    cat_bst = models.pop("4m")
    extras["4m"] = drive_prediction_extras("4m", cat_bst, x_cat)
    del x_cat, y_cat
    for cat_label, dense_label in CATEGORICAL_PATHS.items():
        c, d = paths[cat_label], paths[dense_label]
        log("path %s against %s (the same growth, dense): %.3f against %.3f "
            "s per iteration (%.2fx), %d against %d launches and %d against "
            "%d syncs an iteration" % (
                cat_label, dense_label, c["s_per_iter"], d["s_per_iter"],
                c["s_per_iter"] / d["s_per_iter"], c["launches_per_iter"],
                d["launches_per_iter"], c["syncs_per_iter"],
                d["syncs_per_iter"]))

    log_phase(t_start, "4r-4u. the multiclass workload")
    # ---- 4r-4u. the multiclass workload --------------------------------
    x_mc, y_mc = multiclass_data(MULTICLASS_ROWS)
    xv, yv = multiclass_data(MULTICLASS_VALID_ROWS, seed=1)
    t0 = time.perf_counter()
    ds = lgb.Dataset(x_mc, label=y_mc, params=PARAMS).construct()
    binning_s = time.perf_counter() - t0
    valid = ds.create_valid(xv, label=yv).construct()
    log("binning: %.2f s for %d x %d in %d classes, the valid set's %d rows "
        "%.2f s more" % (binning_s, *x_mc.shape, NUM_CLASS, len(xv),
                         time.perf_counter() - t0 - binning_s))
    for label in MULTICLASS_PATHS:
        paths[label] = drive_multiclass_path(
            label, ds, x_mc, (valid, xv) if label == "4r" else None, models)
        paths[label]["binning_s"] = binning_s
    del ds, valid
    log_phase(t_start, "4zs. prediction extras of 4r")
    mc_bst = models.pop("4r")
    extras["4r"] = drive_prediction_extras("4r", mc_bst, x_mc,
                                           early_stop=True)
    models.clear()
    del x_mc, y_mc
    for label, (dense_label, _) in MULTICLASS_PATHS.items():
        m, d = paths[label], paths[dense_label]
        log("path %s against %s (the same growth, dense binary): %.3f "
            "against %.3f s per iteration (%.2fx), %d against %d launches "
            "and %d against %d syncs an iteration" % (
                label, dense_label, m["s_per_iter"], d["s_per_iter"],
                m["s_per_iter"] / d["s_per_iter"], m["launches_per_iter"],
                d["launches_per_iter"], m["syncs_per_iter"],
                d["syncs_per_iter"]))

    log_phase(t_start, "4zx. serving")
    # ---- 4zx. serving: a frontier model, 4m's and 4r's boosters --------
    paths["4zx"] = drive_serving_path(cat_bst, mc_bst, tmp, dev)
    log_phase(t_start, "4zzi. serving observability: 4zx's frontier model")
    paths["4zzi"] = drive_traced_serving_path(tmp, dev)
    log_phase(t_start, "4zze (4r). refit of the 5-class booster")
    paths["4zze_4r"] = drive_multiclass_refit(mc_bst)
    log_phase(t_start, "4zzf. QoS and the cascade autotuner: 4m and 4r")
    paths["4zzf"] = drive_qos_path(cat_bst, mc_bst)
    del cat_bst, mc_bst
    return {"paths": {k: v for k, v in paths.items() if k not in dense},
            "extras": extras, "renewal": renewal,
            "bundled_rows": bundled_rows, "cat_rows": cat_rows}


def part_compare(dense: dict, tmp: str, t_start: float) -> dict:
    """Part ``compare``: the ranking and cross-entropy paths 4v-4za, 4zg
    and 4zp, each beside the dense path of its growth mode in ``dense``,
    the lambdarank gradient at scale, 4zy, 4zz, 4zzb and 4zw, then phase 5
    on the first COMPARE_ROWS rows of each workload's data; ``tmp`` is the
    part's directory."""
    dev = torch.device("cuda", 0)
    paths = dict(dense)
    log_phase(t_start, "4v-4za. ranking and cross-entropy")
    # ---- 4v-4za. ranking and cross-entropy -----------------------------
    rank_scale = drive_ranking_workloads(paths, dev)

    x, y = bench_data(MAIN_ROWS)
    log_phase(t_start, "4zy. out-of-core streaming")
    # ---- 4zy. out-of-core streaming (Queue 1 #11) ----------------------
    paths["4zy"] = drive_stream_path(x, y, dense, tmp)
    log_phase(t_start, "4zz. packed bin words in memory")
    # ---- 4zz. packed bin words in memory (Queue 1 #9) ------------------
    paths.update(drive_packed_paths(x, y, dense, load_frontier_ref(tmp)))
    log_phase(t_start, "4zzb. streamed resume on words")
    # ---- 4zzb. streamed resume on words (#12) ---------------------------
    paths["4zzb"] = drive_streamed_resume(x, y, tmp)
    log_phase(t_start, "4zw. resetting the training data")
    # ---- 4zw. resetting the training data (#20) -------------------------
    paths["4zw"] = drive_reset_path(x, y, *bench_data(VALID_ROWS, seed=1))
    log_phase(t_start, "4zzh. training observability")
    # ---- 4zzh. training observability (#15 slice b) ---------------------
    ds = lgb.Dataset(x, label=y, params=PARAMS).construct()
    paths["4zzh"] = drive_observability_path(ds, x, y, tmp)
    del ds

    log_phase(t_start, "5. kernel path against plain path")
    # ---- 5. kernel path against plain path -----------------------------
    xs, ys = x[:COMPARE_ROWS], y[:COMPARE_ROWS]
    ds = lgb.Dataset(xs, label=ys, params=PARAMS).construct()
    compare_paths(ds, xs, ys)
    log("kernel vs plain path on bench.py's data (%d rows) streamed in "
        "chunks of %d:" % (len(xs), STREAM_COMPARE_CHUNK_ROWS))
    streamed = dict(GROWTH_PARAMS["frontier"],
                    data_stream_chunk_rows=STREAM_COMPARE_CHUNK_ROWS)
    stream_compare = compare_paths(
        lgb.Dataset(xs, label=ys, params=dict(PARAMS, **streamed))
        .construct(), xs, ys,
        runs=[("frontier, streamed", streamed,
               "build_histogram_slots_words_cuda")])
    for what, extra in SAMPLED_COMPARE.items():
        log("kernel vs plain path on bench.py's data (%d rows), %s:"
            % (len(xs), what))
        compare_paths(ds, xs, ys, runs=[
            ("%s, %s" % (label, what), dict(params, **extra), wrapper)
            for label, params, wrapper in COMPARE_RUNS], plains=(True,))
    log("kernel vs plain path on bench.py's data (%d rows), monotone "
        "constraints, and forced splits with CEGB:" % len(xs))
    compare_paths(ds, xs, ys, runs=constraint_compare_runs(tmp),
                  plains=(True,))
    f64_compare = {"dense": compare_f64(ds, xs, "dense")}
    f64_compare["dense, forced splits and CEGB"] = compare_f64(
        ds, xs, "dense", dict(constraint_params("forced", tmp),
                              **constraint_params("cegb", tmp)),
        ("build_histogram_f64_cuda", "build_histogram_leaf_f64_cuda"))
    del ds
    x_bundled, y_bundled = bundled_data(MAIN_ROWS)
    xs, ys = x_bundled[:COMPARE_ROWS], y_bundled[:COMPARE_ROWS]
    del x_bundled, y_bundled
    log("kernel vs plain path on the bundled data (%d rows):" % len(xs))
    ds = lgb.Dataset(xs, label=ys, params=PARAMS).construct()
    compare_paths(ds, xs, ys, BUNDLED_RAW_TOL)
    f64_compare["bundled"] = compare_f64(ds, xs, "bundled")
    del ds
    x_cat, y_cat = categorical_data(MAIN_ROWS)
    xs, ys = x_cat[:COMPARE_ROWS], y_cat[:COMPARE_ROWS]
    del x_cat, y_cat
    log("kernel vs plain path on the categorical data (%d rows):" % len(xs))
    # the id columns are dense, so none joins an EFB bundle and identical
    # trees must predict within 1e-5; a bundle would bring the bundled
    # data's rounding of rebuilt default bins (BUNDLED_RAW_TOL)
    ds = lgb.Dataset(xs, label=ys, params=PARAMS,
                     categorical_feature=CATEGORICAL_FEATURES).construct()
    compare_paths(ds, xs, ys,
                  BUNDLED_RAW_TOL if ds._binned.has_bundles else 1e-5)
    del ds
    x_mc, y_mc = multiclass_data(MULTICLASS_ROWS)
    xs, ys = x_mc[:COMPARE_ROWS], y_mc[:COMPARE_ROWS]
    log("kernel vs plain path on the multiclass data (%d rows, %d "
        "classes):" % (len(xs), NUM_CLASS))
    compare_paths(lgb.Dataset(xs, label=ys, params=PARAMS).construct(), xs,
                  ys, runs=[("4t batched, multiclass",
                             dict(GROWTH_PARAMS["batched"],
                                  objective="multiclass",
                                  **objective_params("multiclass")),
                             "build_histogram_slots6_cuda")], plains=(True,))
    return {"paths": {k: v for k, v in paths.items() if k not in dense},
            "rank_scale": rank_scale, "f64_compare": f64_compare,
            "stream_compare": stream_compare}


def run(tmp: str) -> int:
    """Phases 1-6; ``tmp`` holds the forced-splits file, the files of 4zr
    and 4zv, and the parts' directories."""
    t_start = time.perf_counter()
    # ---- 1. the card ---------------------------------------------------
    card = card_line()
    dev = torch.device("cuda", 0)
    log("card: %s" % card)
    log("torch %s, CUDA %s, python %s" % (torch.__version__,
                                           torch.version.cuda,
                                           sys.version.split()[0]))

    log_phase(t_start, "2. build every kernel from the sources")
    # ---- 2. build every kernel from the sources ------------------------
    t0 = time.perf_counter()
    builds = port_device.build_libraries(dict(kernels.LIBRARIES))
    log("build: %.2f s for %s" % (time.perf_counter() - t0,
                                   sorted(builds) or "(cached)"))
    for rec in builds.values():
        for line in rec.log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log("  ptxas %s: %s" % (rec.name, line.strip()))
        log("  %s built in %.2f s" % (rec.name, rec.seconds))

    log_phase(t_start, "3. kernels against plain, timed")
    # ---- 3. kernels against plain, timed -------------------------------
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    hist_rows = check_histogram_kernel(dev, flush)
    leaf_rows = check_leaf_histogram(dev, flush)
    f64_rows = check_histogram_f64(dev, flush)
    slot_rows = check_slot_kernels(dev, flush)
    word_hist_rows, word_slot_rows = check_word_kernels(dev, flush)
    part_rows = check_part_kernel(dev, flush)
    repack_rows = check_partition_kernel(dev, flush)
    mask_draw = time_mask_draw(dev, flush)
    del flush

    log_phase(t_start, "4. the main paths at full width")
    # ---- 4. the main paths at full width -------------------------------
    x, y = bench_data(MAIN_ROWS)
    t0 = time.perf_counter()
    ds = lgb.Dataset(x, label=y, params=PARAMS).construct()
    binning_s = time.perf_counter() - t0
    log("binning: %.2f s for %d x %d" % (binning_s, *x.shape))
    models, extras = {}, {}
    paths = {g: drive_path(g, ds, x, y, models) for g in GROWTH_PARAMS}
    paths["exact"]["binning_s"] = binning_s
    refs = reference_forests(models, x, y)
    save_frontier_ref(models["frontier"], tmp)
    procs = start_parts(paths, tmp, t_start)
    try:
        log_phase(t_start, "4q. a custom objective")
        paths["4q"] = drive_fobj_path(ds, x, y)
        check_parts(procs)
        dense_part(paths, models, extras, ds, x, y, tmp, t_start, procs,
                   refs)
        del ds
        results = join_parts(procs, t_start)
    finally:
        stop_parts(procs)
    for result in results.values():
        paths.update(result["paths"])
    extras.update(results["workloads"]["extras"])
    renewal = results["workloads"]["renewal"]
    bundled_rows = results["workloads"]["bundled_rows"]
    cat_rows = results["workloads"]["cat_rows"]
    rank_scale = results["compare"]["rank_scale"]
    f64_compare = results["compare"]["f64_compare"]
    stream_compare = results["compare"]["stream_compare"]

    log_phase(t_start, "6. result lines")
    # ---- 6. result lines -----------------------------------------------
    def launches(name):
        return sum(p["launches"][name] for p in paths.values())

    # each kernel's shapes: the dense ones, headline first, then the
    # bundled workload's
    hist_rows += bundled_rows["histogram"] + cat_rows["histogram"]
    leaf_headline = max(leaf_rows, key=lambda r: r["leaf_rows"])
    part_rows += bundled_rows["hist_part"]
    k3 = [r for r in slot_rows if r["K"] == 3] + bundled_rows["hist_slots"]
    k6 = [r for r in slot_rows if r["K"] == 6] + bundled_rows["hist_slots6"]
    print(json.dumps({"kernels": [
        kernel_entry("histogram", "lightgbm_tpu_torch/core/csrc/histogram.cu",
                     "lightgbm_tpu/core/histogram_pallas.py:67",
                     launches("build_histogram_cuda"), hist_rows,
                     hist_rows[0]),
        dict(kernel_entry("histogram_leaf",
                          "lightgbm_tpu_torch/core/csrc/histogram.cu",
                          "lightgbm_tpu/core/histogram_pallas.py:67",
                          launches("build_histogram_leaf_cuda"), leaf_rows,
                          leaf_headline),
             note="histogram.cu's kernel through hist_for_leaf (a forced "
                  "split's rebuild of one leaf, path 4zl), counted apart "
                  "from the split pass"),
        dict(kernel_entry("histogram_f64",
                          "lightgbm_tpu_torch/core/csrc/histogram.cu",
                          "lightgbm_tpu/core/histogram.py:51",
                          launches("build_histogram_f64_cuda"), f64_rows,
                          f64_rows[0]),
             leaf_launches=launches("build_histogram_leaf_f64_cuda"),
             phase5_forced_leaf_launches=f64_compare[
                 "dense, forced splits and CEGB"]["launches"][
                 "build_histogram_leaf_f64_cuda"],
             note="histogram.cu's float64 variant (gpu_use_dp, exact growth: "
                  "paths 4zn-4zp, 4zr, 4zv, 4zw, 4zza, 4zzc, 4zzd); the "
                  "JAX package computes this in "
                  "XLA (core/histogram.py:51 _hist_scatter on the CPU, :34 "
                  "_hist_chunk_matmul on a TPU), not in a Pallas kernel. "
                  "Its hist_for_leaf route (build_histogram_leaf_f64_cuda) "
                  "has leaf_launches on the phase-4 paths; phase 5's f64 "
                  "forced-splits-with-CEGB comparison, which is not a main "
                  "path, launches it phase5_forced_leaf_launches times"),
        kernel_entry("hist_slots",
                     "lightgbm_tpu_torch/core/csrc/hist_slots.cu",
                     "lightgbm_tpu/core/histogram_pallas.py:384",
                     launches("build_histogram_slots_cuda"), k3,
                     max(k3, key=lambda r: (r.get("data") is None, r["S"]))),
        dict(kernel_entry("histogram_words",
                          "lightgbm_tpu_torch/core/csrc/histogram.cu",
                          "lightgbm_tpu/core/histogram_pallas.py:67",
                          launches("build_histogram_words_cuda"),
                          word_hist_rows, word_hist_rows[0]),
             note="histogram.cu on packed bin words (tpu_bin_packing; the "
                  "root of every frontier tree on words, once a chunk when "
                  "streamed: paths 4zy, 4zz, 4zzb), read in place at a row "
                  "stride of 4 W bytes; the TPU kernel unpacks the words "
                  "in XLA first (histogram_pallas.py:139-143). Each shape "
                  "has the uint8 variant's time on the same codes (u8_ms)"),
        dict(kernel_entry("hist_slots_words",
                          "lightgbm_tpu_torch/core/csrc/hist_slots.cu",
                          "lightgbm_tpu/core/histogram_pallas.py:384",
                          launches("build_histogram_slots_words_cuda"),
                          word_slot_rows, word_slot_rows[0]),
             phase5_streamed_launches=stream_compare[
                 "frontier, streamed"]["launches"],
             note="hist_slots.cu (K=3) on packed bin words: every "
                  "frontier wave on words, once a chunk when streamed "
                  "(4zy, 4zz, 4zzb); the TPU kernel unpacks them first "
                  "(histogram_pallas.py:464-465). u8_ms: the uint8 "
                  "variant on the same codes"),
        kernel_entry("hist_slots6",
                     "lightgbm_tpu_torch/core/csrc/hist_slots.cu",
                     "lightgbm_tpu/core/histogram_pallas.py:175",
                     launches("build_histogram_slots6_cuda"), k6, k6[0]),
        kernel_entry("hist_part", "lightgbm_tpu_torch/core/csrc/hist_part.cu",
                     "lightgbm_tpu/core/histogram_pallas.py:264",
                     launches("build_histogram_part_tiles_cuda"), part_rows,
                     next(r for r in part_rows if r.get("shape") == "C")),
        dict(kernel_entry("partition_tiles",
                          "lightgbm_tpu_torch/core/csrc/repack.cu",
                          "lightgbm_tpu/core/repack_pallas.py:31",
                          launches("partition_tiles_cuda"), repack_rows,
                          repack_rows[0]),
             note="no grower calls partition_tiles (the JAX package's do "
                  "not either), so no path launches it; its phase-3 calls "
                  "are its only launches")],
        "paths": paths, "renewal": renewal, "rank_scale": rank_scale,
        "mask_draw": mask_draw, "f64_compare": f64_compare,
        "prediction_extras": extras}),
        flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
