"""Command-line application.

The port's own copy of ``lightgbm_tpu/cli.py`` (src/main.cpp and
src/application/application.cpp of the reference):
``python -m lightgbm_tpu_torch [config=train.conf] [key=value ...]`` runs
one of the reference's tasks (include/LightGBM/application.h:74):

- ``task=train``         - load data, train, save the model
  (application.cpp:202)
- ``task=predict``       - score a file (application.cpp:213-250)
- ``task=convert_model`` - the model as a standalone C++ if-else scorer
  (gbdt_model_text.cpp:60-243 ModelToIfElse)
- ``task=refit``         - refit ``input_model``'s leaf values on
  ``data`` (``refit_decay_rate``; ``Booster.refit``), save the model
- ``task=serve``         - serve ``input_model`` over HTTP
  (``serve_host``, ``serve_port``) or JSON lines on stdin
  (``serve_stdin=true``): ``serving/server.py`` ``run_server``

``key=value`` tokens on the command line and an optional ``config=`` file
of ``key=value`` lines with ``#`` comments, the command line taking
precedence (Application::LoadParameters, application.cpp:48-81).

Device: LightGBM's ``device_type`` key (alias ``device``). ``cpu`` runs on
the CPU; anything else, the default included, runs on CUDA and raises when
CUDA is absent. Training takes ``checkpoint_dir`` (with
``checkpoint_period`` and ``checkpoint_keep``), ``resume=<dir>`` and
``supervise=true`` (cli.py:122-147 of the JAX package), the
``observability`` and ``obs_*`` keys, and ``health_monitor=abort|raise``,
which attaches ``callback.health_monitor`` so that each iteration is
checked as it ends (cli.py:129-134 there).
"""
from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional

import numpy as np

from .boosting.gbdt import check_slice
from .config import Config
from .log import Log, LightGBMError


def kv2map(tokens: List[str], strip_comments: bool = False) -> Dict[str, str]:
    """key=value tokens (Config::KV2Map, config.cpp:15). ``#`` comments are
    stripped only from a config file's lines: a value on the command line
    may hold ``#`` (a path, say)."""
    out: Dict[str, str] = {}
    for tok in tokens:
        if strip_comments:
            tok = tok.split("#", 1)[0]
        tok = tok.strip()
        if not tok:
            continue
        if "=" not in tok:
            raise LightGBMError("Unknown parameter %r (expected key=value)"
                                % tok)
        k, v = tok.split("=", 1)
        k, v = k.strip(), v.strip()
        if k in out:
            Log.warning("Duplicated parameter %s, keeping first value", k)
            continue
        out[k] = v
    return out


def load_parameters(argv: List[str]) -> Dict[str, str]:
    """The command line's keys, then the config file's for keys not set
    there (application.cpp:48-81)."""
    cmdline = kv2map(argv)
    conf_path = cmdline.pop("config", cmdline.pop("config_file", ""))
    params = dict(cmdline)
    if conf_path:
        with open(conf_path, "r") as fh:
            file_params = kv2map(fh.read().splitlines(), strip_comments=True)
        for k, v in file_params.items():
            params.setdefault(k, v)
    return params


def device_of(config: Config) -> Optional[str]:
    """``device_type=cpu`` is the CPU; anything else is CUDA (None)."""
    return "cpu" if config.device_type.strip().lower() == "cpu" else None


def _load_file_dataset(path: str, config: Config, params: Dict,
                       reference=None):
    """A Dataset of a text file and its sidecar files (.weight, .query,
    .init; the Metadata file convention, src/io/metadata.cpp)."""
    from .basic import Dataset
    from .io import parser as parser_mod

    x, y, names = parser_mod.parse_file(
        path, has_header=config.header, label_column=config.label_column)
    return Dataset(x, label=y, reference=reference,
                   weight=parser_mod.load_weight_file(path),
                   group=parser_mod.load_query_file(path),
                   init_score=parser_mod.load_init_score_file(path),
                   feature_name=(names if names else "auto"),
                   params=dict(params), device=device_of(config))


def run_train(config: Config, params: Dict) -> None:
    from . import engine
    from .callback import print_evaluation

    if not config.data:
        raise LightGBMError("No training data: pass data=<file>")
    # options outside the port refuse before any file is read
    check_slice(config)
    device = device_of(config)
    Log.info("Loading train data %s", config.data)
    train_set = _load_file_dataset(config.data, config, params)
    valid_sets, valid_names = [], []
    for vpath in config.valid:
        Log.info("Loading validation data %s", vpath)
        valid_sets.append(_load_file_dataset(vpath, config, params,
                                             reference=train_set))
        valid_names.append(os.path.basename(vpath))
    if config.save_binary:
        train_set.construct().save_binary(config.data + ".bin")

    callbacks = []
    if config.metric_freq > 0 and config.verbosity >= 0:
        callbacks.append(print_evaluation(period=config.metric_freq))
    snapshot_freq = config.snapshot_freq
    if snapshot_freq > 0:
        out = config.output_model

        def snapshot_cb(env):
            it = env.iteration + 1
            if it % snapshot_freq == 0:
                env.model.save_model("%s.snapshot_iter_%d" % (out, it))
        snapshot_cb.order = 40
        callbacks.append(snapshot_cb)
    if config.checkpoint_dir:
        # full-state snapshots and SIGTERM handling; resume with resume=<dir>
        from .callback import checkpoint as checkpoint_cb
        callbacks.append(checkpoint_cb(config.checkpoint_dir,
                                       period=config.checkpoint_period,
                                       keep_last_n=config.checkpoint_keep))
    if config.health_monitor in ("abort", "raise"):
        # escalating actions want each iteration checked as it ends: the
        # callback runs before an iteration, which keeps the loop off its
        # fused blocks
        from .callback import health_monitor
        callbacks.append(health_monitor(config.health_monitor))

    booster = engine.train(
        dict(params), train_set,
        num_boost_round=config.num_iterations,
        valid_sets=valid_sets or None,
        valid_names=valid_names or None,
        init_model=(config.input_model or None),
        early_stopping_rounds=(config.early_stopping_round
                               if config.early_stopping_round > 0 else None),
        verbose_eval=False, callbacks=callbacks or None,
        resume_from=(config.resume or None),
        supervise=(config.supervise or None), device=device)
    booster.save_model(config.output_model)
    Log.info("Finished training; model saved to %s", config.output_model)
    obs = booster._impl.obs
    if obs.enabled and obs.monitor is not None:
        Log.info("Telemetry: %d health anomalies (%d reports)",
                 obs.monitor.anomaly_count(), len(obs.monitor.reports))


def run_predict(config: Config, params: Dict) -> None:
    from .basic import Booster
    from .io import parser as parser_mod

    if not config.input_model:
        raise LightGBMError("No model file: pass input_model=<file>")
    if not config.data:
        raise LightGBMError("No data for prediction: pass data=<file>")
    booster = Booster(model_file=config.input_model,
                      device=device_of(config))
    x, _, _ = parser_mod.parse_file(config.data, has_header=config.header,
                                    label_column=config.label_column)
    num_iter = (config.num_iteration_predict
                if config.num_iteration_predict > 0 else None)
    pred = booster.predict(x, num_iteration=num_iter,
                           raw_score=config.predict_raw_score,
                           pred_leaf=config.predict_leaf_index,
                           pred_contrib=config.predict_contrib,
                           pred_early_stop=config.pred_early_stop,
                           pred_early_stop_freq=config.pred_early_stop_freq,
                           pred_early_stop_margin=config.pred_early_stop_margin)
    pred = np.atleast_1d(pred)
    with open(config.output_result, "w") as fh:
        if pred.ndim == 1:
            for v in pred:
                fh.write("%.12g\n" % v)
        else:
            for row in pred:
                fh.write("\t".join("%.12g" % v for v in row) + "\n")
    Log.info("Finished prediction; results saved to %s", config.output_result)


def run_convert_model(config: Config, params: Dict) -> None:
    from .basic import Booster
    from .io.model_text import model_to_cpp, parse_model_file

    if not config.input_model:
        raise LightGBMError("No model file: pass input_model=<file>")
    if config.convert_model_language not in ("", "cpp"):
        raise LightGBMError("Unsupported convert_model_language %r "
                            "(only cpp)" % config.convert_model_language)
    # loaded as a booster first, as every task loads a model
    Booster(model_file=config.input_model, device=device_of(config))
    code = model_to_cpp(parse_model_file(config.input_model))
    with open(config.convert_model, "w") as fh:
        fh.write(code)
    Log.info("Model converted to C++ at %s", config.convert_model)


def run_refit(config: Config, params: Dict) -> None:
    """task=refit (cli.py:204-219 of the JAX package): the model of
    ``input_model`` refitted on ``data`` (with its ``.weight`` and
    ``.query`` sidecars) at ``refit_decay_rate``, saved to
    ``output_model``."""
    from .basic import Booster
    from .io import parser as parser_mod

    if not config.input_model:
        raise LightGBMError("No model file: pass input_model=<file>")
    if not config.data:
        raise LightGBMError("No data for refit: pass data=<file>")
    booster = Booster(model_file=config.input_model, device=device_of(config))
    x, y, _ = parser_mod.parse_file(config.data, has_header=config.header,
                                    label_column=config.label_column)
    refitted = booster.refit(x, y, decay_rate=config.refit_decay_rate,
                             weight=parser_mod.load_weight_file(config.data),
                             group=parser_mod.load_query_file(config.data))
    refitted.save_model(config.output_model)
    Log.info("Finished refit; model saved to %s", config.output_model)


def run_serve(config: Config, params: Dict) -> None:
    from .serving.server import run_server

    run_server(config, params)


_TASKS = {
    "train": run_train, "training": run_train,
    "predict": run_predict, "prediction": run_predict, "test": run_predict,
    "convert_model": run_convert_model,
    "refit": run_refit, "refit_tree": run_refit,
    "serve": run_serve, "serving": run_serve,
}


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    try:
        params = load_parameters(argv)
        config = Config(dict(params))
        task_fn = _TASKS.get(config.task)
        if task_fn is None:
            raise LightGBMError("Unknown task %r" % config.task)
        task_fn(config, params)
        return 0
    except (LightGBMError, OSError, ValueError) as e:
        # the reference's Application prints a one-line error for any
        # exception (main.cpp); so does this for I/O and parse failures
        Log.warning("Met Exceptions: %s", str(e))
        print("Error: %s" % e, file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
