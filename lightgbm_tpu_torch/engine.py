"""Training and cross-validation entry points.

The port of ``lightgbm_tpu/engine.py`` ``train`` (:22, its ``_train_once``
:99-290; the reference's python-package/lightgbm/engine.py:19, boost loop
:211-236) and ``cv`` (:289-489 there; the reference's engine.py:336):
``train`` trains on one device (or a group of ranks, whose model digests
it checks at the end) with validation sets, ``feval``, callbacks,
early stopping, learning-rate schedules, continued training from an
``init_model``, custom objectives (``fobj``, which sets
``objective="none"``), categorical features and row sampling (bagging,
GOSS, DART, RF). Where the JAX engine fuses its loop (no valid sets, no
``fobj``, no callback before an iteration, and only callbacks after one
that read evaluation results, which such a run has none of), the port
trains through ``GBDT.train_many``, so that its bagging and GOSS draws
follow the same key stream (engine.py:221-229 there). Callbacks run before and
after each iteration, ``EarlyStopException`` unwinds the loop and sets
``best_iteration``, and ``evals_result`` records the history. Every run
exports its evaluations as ``lgbm_eval_metric`` gauges
(``callback.export_eval_metrics``, unless the caller passed one), a crash
in the loop flushes the booster's event stream and flight recorder and
carries the dump's path on the exception (``flight_dump_path``), and the
end of the run flushes its telemetry (engine.py:174-178, :262-285 there).
Checkpoints (``checkpoint_dir``, ``callback.checkpoint``) snapshot the
training state; ``resume_from`` puts it back and trains the rest of the
total on the per-iteration path, and ``supervise`` restarts a crashed run
from the newest snapshot (engine.py:37-110, :181-213 there).

``cv`` makes the JAX package's folds index for index (stratified, plain,
group-aware or the caller's), bins each fold's training rows on their own
with the fold's test rows as its validation set, and trains the folds a
round at a time on one device, aggregating each metric's mean and
standard deviation across them.
"""
from __future__ import annotations

import collections
import copy
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from . import callback
from .basic import Booster, Dataset, _InnerPredictor, _to_2d_float
from .config import Config
from .device import DeviceLike, resolve_device
from .io.parser import parse_file
from .log import Log, check

_NUM_ROUND_ALIASES = ("num_boost_round", "num_iterations", "num_iteration",
                      "num_tree", "num_trees", "num_round", "num_rounds",
                      "n_estimators")


_EARLY_STOPPING_ALIASES = ("early_stopping_round", "early_stopping_rounds",
                           "early_stopping")


def _sorted_callbacks(cbs: List[Callable]):
    """The callbacks before and after an iteration, each sorted stably by
    ``order``, so callbacks of equal order run as registered."""
    def phase(before: bool):
        return sorted((c for c in cbs
                       if bool(getattr(c, "before_iteration", False))
                       == before), key=lambda c: getattr(c, "order", 0))
    return phase(True), phase(False)


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          fobj: Optional[Callable] = None,
          feval: Optional[Callable] = None,
          init_model: Optional[Union[str, Booster]] = None,
          feature_name: Union[str, List[str]] = "auto",
          categorical_feature: Union[str, List] = "auto",
          early_stopping_rounds: Optional[int] = None,
          evals_result: Optional[Dict] = None,
          verbose_eval: Union[bool, int] = True,
          learning_rates: Optional[Union[List[float], Callable]] = None,
          keep_training_booster: bool = False,
          callbacks: Optional[List[Callable]] = None,
          resume_from: Optional[str] = None,
          supervise: Optional[bool] = None,
          device: DeviceLike = None) -> Booster:
    """engine.py:22 — train a Booster on ``device`` (CUDA unless the
    caller passes ``device="cpu"``).

    ``resume_from`` (or ``resume`` in ``params``) is a checkpoint directory
    to continue from: ``num_boost_round`` stays the total, so a run
    checkpointed at iteration k trains the remaining ``num_boost_round -
    k`` rounds, and an empty directory starts fresh. ``checkpoint_dir`` in
    ``params`` attaches ``callback.checkpoint`` (``checkpoint_period``,
    ``checkpoint_keep``). ``supervise`` (or ``supervise=true`` in
    ``params``, which then needs ``checkpoint_dir``) runs under
    ``resilience.Supervisor``: a crash restarts the run after a backoff,
    resumed from the newest valid snapshot, up to
    ``supervise_max_restarts`` times, with a watchdog over the iterations
    where ``supervise_hang_timeout_s`` is set."""
    args = dict(num_boost_round=num_boost_round, valid_sets=valid_sets,
                valid_names=valid_names, fobj=fobj, feval=feval,
                init_model=init_model, feature_name=feature_name,
                categorical_feature=categorical_feature,
                early_stopping_rounds=early_stopping_rounds,
                evals_result=evals_result, verbose_eval=verbose_eval,
                learning_rates=learning_rates, callbacks=callbacks,
                device=device)
    if supervise is None:
        supervise = Config(copy.deepcopy(params) if params else {}).supervise
    if supervise:
        return _train_supervised(params, train_set, resume_from, args)
    return _train_once(params, train_set, resume_from=resume_from, **args)


def _train_supervised(params, train_set: Dataset, resume_from, args: dict
                      ) -> Booster:
    """``train`` under the in-process supervisor (engine.py:68-100 of the
    JAX package): each attempt after the first resumes from
    ``checkpoint_dir``."""
    from .resilience.supervisor import Supervisor, heartbeat_file_callback
    cfg = Config(copy.deepcopy(params) if params else {})
    sup = Supervisor(cfg.checkpoint_dir,
                     max_restarts=cfg.supervise_max_restarts,
                     backoff_s=cfg.supervise_backoff_s,
                     backoff_max_s=cfg.supervise_backoff_max_s,
                     hang_timeout_s=cfg.supervise_hang_timeout_s,
                     warmup_grace_s=cfg.supervise_warmup_grace_s)

    def attempt(resume, watchdog):
        cbs = list(args["callbacks"] or [])
        if watchdog is not None:
            cbs.append(watchdog.callback())
        if cfg.supervise_heartbeat_file:
            cbs.append(heartbeat_file_callback(cfg.supervise_heartbeat_file))
        return _train_once(params, train_set,
                           resume_from=(resume if resume is not None
                                        else resume_from),
                           **dict(args, callbacks=cbs))

    return sup.run(attempt)


def _train_once(params: Dict[str, Any], train_set: Dataset,
                num_boost_round: int = 100,
                valid_sets: Optional[List[Dataset]] = None,
                valid_names: Optional[List[str]] = None,
                fobj: Optional[Callable] = None,
                feval: Optional[Callable] = None,
                init_model: Optional[Union[str, Booster]] = None,
                feature_name: Union[str, List[str]] = "auto",
                categorical_feature: Union[str, List] = "auto",
                early_stopping_rounds: Optional[int] = None,
                evals_result: Optional[Dict] = None,
                verbose_eval: Union[bool, int] = True,
                learning_rates: Optional[Union[List[float], Callable]] = None,
                callbacks: Optional[List[Callable]] = None,
                resume_from: Optional[str] = None,
                device: DeviceLike = None) -> Booster:
    """One training run (engine.py:99-290 of the JAX package)."""
    params = copy.deepcopy(params) if params else {}
    for alias in _NUM_ROUND_ALIASES:
        if alias in params:
            num_boost_round = int(params.pop(alias))
    for alias in _EARLY_STOPPING_ALIASES:
        if params.get(alias) is not None:
            early_stopping_rounds = int(params.pop(alias))
    if fobj is not None:
        params["objective"] = "none"
    if feature_name != "auto":
        train_set.feature_name = feature_name
    if categorical_feature != "auto":
        train_set.categorical_feature = categorical_feature
    if isinstance(init_model, str):
        init_model = Booster(model_file=init_model, device=device)
    # set on every call, so a Dataset reused without an init model does not
    # keep an earlier run's
    train_set._set_predictor(None if init_model is None
                             else _InnerPredictor(init_model))

    booster = Booster(params=params, train_set=train_set, device=device)
    is_valid_contain_train = False
    fused = valid_sets is None and fobj is None
    if valid_sets is not None:
        if isinstance(valid_sets, Dataset):
            valid_sets = [valid_sets]
        names = valid_names or ["valid_%d" % i for i in range(len(valid_sets))]
        for vs, name in zip(valid_sets, names):
            if vs is train_set:
                is_valid_contain_train = True
                booster.train_set_name = name
                continue
            booster.add_valid(vs, name)

    cbs = list(callbacks or [])
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        cbs.append(callback.early_stopping(
            early_stopping_rounds,
            first_metric_only=bool(booster.config.first_metric_only)))
    if verbose_eval is True:
        cbs.append(callback.print_evaluation())
    elif isinstance(verbose_eval, int) and verbose_eval:
        cbs.append(callback.print_evaluation(verbose_eval))
    if evals_result is not None:
        cbs.append(callback.record_evaluation(evals_result))
    # every evaluated iteration also lands in the process metrics registry
    # (lgbm_eval_metric gauges) for the stats endpoints; it only consumes
    # evaluations, so a run without them still takes the fused loop
    if not any(isinstance(c, callback._ExportEvalMetrics) for c in cbs):
        cbs.append(callback.export_eval_metrics())
    if learning_rates is not None:
        cbs.append(callback.reset_parameter(learning_rate=learning_rates))
    # checkpoint_dir attaches the checkpoint callback (the command line's
    # way; Python callers may pass callback.checkpoint themselves)
    cfg = booster.config
    if cfg.checkpoint_dir and not any(getattr(c, "is_checkpoint", False)
                                      for c in cbs):
        cbs.append(callback.checkpoint(cfg.checkpoint_dir,
                                       period=cfg.checkpoint_period,
                                       keep_last_n=cfg.checkpoint_keep))
    cbs_before, cbs_after = _sorted_callbacks(cbs)
    # the checkpoint callback reads the loop's state (early stopping) off
    # the booster when it saves
    booster._callbacks = cbs_before + cbs_after

    # resume: the driver's and the callbacks' state back, the budget cut
    # to what the total leaves
    resumed = False
    resume_from = resume_from or cfg.resume
    if resume_from:
        from . import checkpoint as ckpt_mod
        handle = ckpt_mod.load_latest(resume_from)
        if handle is None:
            Log.info("resume_from=%s: no checkpoint found; starting fresh",
                     resume_from)
        else:
            completed = ckpt_mod.restore(booster, handle,
                                         cbs_before + cbs_after)
            num_boost_round = max(num_boost_round - completed, 0)
            resumed = True

    begin = booster.current_iteration()
    try:
        evaluation_result_list = _boost(
            booster, params, num_boost_round, fobj, feval,
            fused and not resumed, is_valid_contain_train, cbs_before,
            cbs_after)
    except callback.EarlyStopException:
        raise
    except Exception as train_err:
        # the crash path: the event stream fsynced, the flight recorder
        # dumped, and its path carried to the supervisor or the operator
        obs = booster._impl.obs
        if not getattr(train_err, "flight_dump_path", None):
            try:
                dump = obs.crash_flush("train-exception: %s: %s"
                                       % (type(train_err).__name__,
                                          train_err))
                if dump:
                    train_err.flight_dump_path = dump
            except Exception:   # the dump must never mask the crash
                pass
        obs.release()
        raise

    booster.best_score = collections.defaultdict(dict)
    for data_name, eval_name, score, _ in evaluation_result_list or []:
        booster.best_score[data_name][eval_name] = score
    if booster.best_iteration <= 0:
        booster.best_iteration = booster.current_iteration()
    obs = booster._impl.obs
    if obs.enabled:
        # flush the event stream and close any open profiler window; the
        # stats endpoint stays up for post-train scrapes
        obs.finish()
    if booster._impl._comm is not None:
        # every rank must hold the same model (network.py:277-310 of the
        # JAX package): a difference is a real divergence, never a tie
        booster.model_digests = booster._impl.check_model_agreement(
            booster._model_text)
    return booster


def _boost(booster: Booster, params, num_boost_round: int, fobj, feval,
           fusable: bool, is_valid_contain_train: bool, cbs_before,
           cbs_after) -> list:
    """The boosting loop (engine.py:211-246 of the JAX package): returns
    the last evaluation results (the best ones after an early stop)."""
    begin = booster.current_iteration()
    end = begin + num_boost_round
    evaluation_result_list = []
    if fusable and not cbs_before and all(
            getattr(c, "only_consumes_evals", False) for c in cbs_after):
        # nothing reads the booster between iterations: the JAX engine's
        # fused loop, and its key stream
        booster._impl.train_many(num_boost_round)
        end = begin
    for i in range(begin, end):
        for cb in cbs_before:
            cb(callback.CallbackEnv(model=booster, params=params, iteration=i,
                                    begin_iteration=begin, end_iteration=end,
                                    evaluation_result_list=None))
        stopped = booster.update(fobj=fobj)
        evaluation_result_list = []
        if is_valid_contain_train:
            evaluation_result_list.extend(booster.eval_train(feval))
        evaluation_result_list.extend(booster.eval_valid(feval))
        try:
            for cb in cbs_after:
                cb(callback.CallbackEnv(
                    model=booster, params=params, iteration=i,
                    begin_iteration=begin, end_iteration=end,
                    evaluation_result_list=evaluation_result_list))
        except callback.EarlyStopException as stop:
            booster.best_iteration = stop.best_iteration + 1
            evaluation_result_list = stop.best_score
            break
        if stopped:
            break
    return evaluation_result_list


class CVBooster:
    """The folds' boosters that ``cv(return_cvbooster=True)`` returns
    (engine.py:289 of the JAX package)."""

    def __init__(self):
        self.boosters: List[Booster] = []
        self.best_iteration = -1

    def append(self, booster: Booster) -> None:
        self.boosters.append(booster)


def _fold_pairs(num_data: int, test_folds) -> list:
    """(train indices, test indices) of each fold from its test rows."""
    out = []
    for test_idx in test_folds:
        mask = np.ones(num_data, bool)
        mask[test_idx] = False
        out.append((np.where(mask)[0], test_idx))
    return out


def _make_n_folds(full_data: Dataset, folds, nfold: int, params, seed: int,
                  stratified: bool, shuffle: bool):
    """The folds as (train indices, test indices), the JAX package's index
    for index (engine.py:300-359 there): the caller's ``folds`` (an
    iterable of pairs, or an object with ``split`` called with the rows'
    query ids), else from ``np.random.RandomState(seed)``: whole queries
    dealt round-robin after a shuffle when the data have query groups,
    each label's rows dealt round-robin when ``stratified``, else the rows
    dealt round-robin."""
    full_data = full_data.construct()
    num_data = full_data.num_data()
    if folds is not None:
        if not hasattr(folds, "__iter__") and hasattr(folds, "split"):
            group = full_data.get_group()
            groups = (None if group is None else np.repeat(
                range(len(group)), repeats=np.asarray(group, np.int64)))
            folds = folds.split(X=np.zeros(num_data),
                                y=full_data.get_label(), groups=groups)
        return list(folds)
    rng = np.random.RandomState(seed)
    group = full_data.get_group()
    if group is not None:
        gidx = np.arange(len(group))
        if shuffle:
            rng.shuffle(gidx)
        boundaries = np.concatenate([[0], np.cumsum(np.asarray(group))])
        tests = []
        for k in range(nfold):
            test_g = gidx[k::nfold]
            tests.append(np.concatenate(
                [np.arange(boundaries[g], boundaries[g + 1])
                 for g in test_g]) if len(test_g) else np.array([], np.int64))
        return _fold_pairs(num_data, tests)
    if stratified:
        label = np.asarray(full_data.get_label())
        per_fold = [[] for _ in range(nfold)]
        for c in np.unique(label):
            cls_idx = np.where(label == c)[0]
            if shuffle:
                rng.shuffle(cls_idx)
            for k in range(nfold):
                per_fold[k].append(cls_idx[k::nfold])
        return _fold_pairs(num_data, [np.sort(np.concatenate(t))
                                      for t in per_fold])
    idx = np.arange(num_data)
    if shuffle:
        rng.shuffle(idx)
    return _fold_pairs(num_data, [np.sort(idx[k::nfold])
                                  for k in range(nfold)])


def _agg_cv_result(raw_results):
    """Each metric's (``cv_agg``, "<data> <metric>", mean, bigger_better,
    standard deviation) across the folds (engine.py:362-373 of the JAX
    package)."""
    cvmap = collections.OrderedDict()
    metric_type = {}
    for one_result in raw_results:
        for data_name, metric, value, bigger_better in one_result:
            key = data_name + " " + metric
            metric_type[key] = bigger_better
            cvmap.setdefault(key, []).append(value)
    return [("cv_agg", k, float(np.mean(v)), metric_type[k], float(np.std(v)))
            for k, v in cvmap.items()]


def _raw_matrix(ds: Dataset) -> np.ndarray:
    """The raw feature matrix the folds are cut from (engine.py:481-489 of
    the JAX package): a file is parsed again, anything else converted."""
    if isinstance(ds.data, str):
        cfg = Config(ds.params)
        return parse_file(ds.data, has_header=cfg.header,
                          label_column=cfg.label_column)[0]
    return _to_2d_float(ds.data)


def cv(params: Dict[str, Any], train_set: Dataset, num_boost_round: int = 100,
       folds=None, nfold: int = 5, stratified: bool = True,
       shuffle: bool = True, metrics=None, fobj=None, feval=None,
       init_model=None, feature_name="auto", categorical_feature="auto",
       early_stopping_rounds: Optional[int] = None, fpreproc=None,
       verbose_eval=None, show_stdv: bool = True, seed: int = 0,
       callbacks=None, eval_train_metric: bool = False,
       return_cvbooster: bool = False, device: DeviceLike = None):
    """engine.py:376 of the JAX package: k-fold cross-validation on
    ``device`` (CUDA unless the caller passes ``device="cpu"``). Returns
    ``{"<data> <metric>-mean": [...], "-stdv": [...]}`` a round, cut to the
    best round when early stopping fires, and the ``CVBooster`` under
    ``"cvbooster"`` with ``return_cvbooster``. As in the JAX package,
    ``init_model``, ``feature_name`` and ``categorical_feature`` are taken
    and not used, and a fold's Datasets carry no query groups, so
    lambdarank raises.

    The folds are cut from the raw rows, read before ``train_set`` is
    binned: a Dataset already binned with ``free_raw_data=True`` no longer
    has them and raises."""
    dev = resolve_device(device)
    if train_set.device != dev:
        raise ValueError("the Dataset is on %s but cv runs on %s"
                         % (train_set.device, dev))
    params = copy.deepcopy(params) if params else {}
    for alias in _NUM_ROUND_ALIASES:
        if alias in params:
            num_boost_round = int(params.pop(alias))
    for alias in _EARLY_STOPPING_ALIASES:
        if params.get(alias) is not None:
            early_stopping_rounds = int(params.pop(alias))
    if fobj is not None:
        params["objective"] = "none"
    if metrics is not None:
        params["metric"] = metrics
    if isinstance(params.get("metric"), str):
        params["metric"] = [params["metric"]]
    cfg = Config(params)
    if cfg.checkpoint_dir or cfg.resume or cfg.supervise:
        # as in the JAX package, whose checkpoint callback passes over a
        # CVBooster: the folds are not checkpointed or supervised
        Log.warning("cv keeps no checkpoints and runs unsupervised: "
                    "checkpoint_dir, resume and supervise apply to train")

    check(train_set._binned is None or train_set.data is not None,
          "cv needs the training set's raw rows, which were freed when it "
          "was constructed; pass an unconstructed Dataset or "
          "free_raw_data=False")
    raw_x = _raw_matrix(train_set)
    train_set.construct()
    if params.get("objective") not in ("binary", "multiclass",
                                       "multiclassova") and folds is None:
        stratified = False
    folds_list = _make_n_folds(train_set, folds, nfold, params, seed,
                               stratified, shuffle)

    cvbooster = CVBooster()
    label = np.asarray(train_set.get_label())
    weight = train_set.get_weight()
    for train_idx, test_idx in folds_list:
        dtrain = Dataset(raw_x[train_idx], label=label[train_idx],
                         weight=None if weight is None
                         else np.asarray(weight)[train_idx],
                         params=dict(params),
                         categorical_feature=train_set.categorical_feature,
                         device=dev)
        dtest = dtrain.create_valid(
            raw_x[test_idx], label=label[test_idx],
            weight=None if weight is None else np.asarray(weight)[test_idx])
        fold_params = params
        if fpreproc is not None:
            dtrain, dtest, fold_params = fpreproc(dtrain, dtest, dict(params))
        bst = Booster(params=dict(fold_params), train_set=dtrain, device=dev)
        bst.add_valid(dtest, "valid")
        cvbooster.append(bst)

    results = collections.defaultdict(list)
    cbs = list(callbacks or [])
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        cbs.append(callback.early_stopping(early_stopping_rounds,
                                           verbose=False))
    if verbose_eval is True:
        cbs.append(callback.print_evaluation(show_stdv=show_stdv))
    elif isinstance(verbose_eval, int) and verbose_eval:
        cbs.append(callback.print_evaluation(verbose_eval, show_stdv))
    cbs_before, cbs_after = _sorted_callbacks(cbs)

    for i in range(num_boost_round):
        fold_results = []
        for bst in cvbooster.boosters:
            for cb in cbs_before:
                cb(callback.CallbackEnv(
                    model=bst, params=params, iteration=i, begin_iteration=0,
                    end_iteration=num_boost_round,
                    evaluation_result_list=None))
            bst.update(fobj=fobj)
            one = list(bst.eval_train(feval)) if eval_train_metric else []
            one.extend(bst.eval_valid(feval))
            fold_results.append(one)
        agg = _agg_cv_result(fold_results)
        for _, key, mean, _, std in agg:
            results[key + "-mean"].append(mean)
            results[key + "-stdv"].append(std)
        try:
            for cb in cbs_after:
                cb(callback.CallbackEnv(
                    model=cvbooster, params=params, iteration=i,
                    begin_iteration=0, end_iteration=num_boost_round,
                    evaluation_result_list=agg))
        except callback.EarlyStopException as stop:
            cvbooster.best_iteration = stop.best_iteration + 1
            for key in list(results):
                results[key] = results[key][:cvbooster.best_iteration]
            break

    if return_cvbooster:
        results["cvbooster"] = cvbooster
    return dict(results)
