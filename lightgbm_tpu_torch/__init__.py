"""lightgbm_tpu_torch: the PyTorch and CUDA port of lightgbm_tpu.

A second package beside ``lightgbm_tpu`` with its public surface:
``Dataset``, ``Booster``, ``train``, ``cv`` and ``CVBooster``, the
training callbacks, the scikit-learn estimators (``LGBMRegressor``,
``LGBMClassifier``, ``LGBMRanker``), the plotting functions and the
``key=value`` command line (``python -m lightgbm_tpu_torch``).

It trains the regression family, binary, multiclass (softmax and
one-vs-all), lambdarank, cross-entropy and custom objectives on
numerical and categorical features, with EFB bundles and packed
small-feature pairs, from dense arrays, DataFrames, scipy sparse
matrices, text files and the binary cache; with float32 or float64
histograms, bagging, GOSS, DART and RF, monotone constraints, forced
splits and CEGB; on one device, with leaf-wise exact, frontier-wave or
top-K batched growth (``tree_growth``; batched also over rows kept
grouped by leaf with ``tpu_batched_part=true``); with validation sets,
early stopping, learning-rate schedules, continued training and a swap of
the training set (``Booster.reset_training_data``). It predicts raw
scores, probabilities, leaf ids, SHAP values and early-stopped scores,
and saves, loads, pickles, dumps and converts models; ``serving`` serves
them (``Booster.as_serving_bundle``, ``python -m lightgbm_tpu_torch
task=serve``) with a CUDA graph a shape bucket, each response
``predict``'s bit for bit. The histogram
passes run as CUDA kernels written for Hopper
(``core/csrc/histogram.cu``, ``hist_slots.cu`` and ``hist_part.cu``), as
does the in-tile row partition (``core/csrc/repack.cu``); everything else
is PyTorch. Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""
from . import callback
from .basic import Booster, Dataset
from .callback import (early_stopping, print_evaluation, record_evaluation,
                       reset_parameter)
from .config import Config
from .engine import CVBooster, cv, train
from .log import LightGBMError, Log
from .plotting import (create_tree_digraph, plot_importance, plot_metric,
                       plot_tree)
from .sklearn import LGBMClassifier, LGBMModel, LGBMRanker, LGBMRegressor

__all__ = ["Booster", "CVBooster", "Config", "Dataset", "LGBMClassifier",
           "LGBMModel", "LGBMRanker", "LGBMRegressor", "LightGBMError",
           "Log", "callback", "create_tree_digraph", "cv", "early_stopping",
           "plot_importance", "plot_metric", "plot_tree", "print_evaluation",
           "record_evaluation", "reset_parameter", "train"]
