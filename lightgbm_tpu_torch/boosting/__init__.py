"""Boosting drivers (include/LightGBM/boosting.h:22-294).

``create_boosting`` mirrors Boosting::CreateBoosting
(src/boosting/boosting.cpp:30-45) as ``lightgbm_tpu/boosting/__init__.py``
does: "gbdt" | "dart" | "goss" | "rf".
"""
from typing import List, Optional

import torch

from ..config import Config
from ..log import LightGBMError
from .gbdt import GBDT, HostTree


def create_boosting(config: Config, train_data=None, objective=None,
                    metrics: Optional[List] = None,
                    device: torch.device = torch.device("cpu")) -> GBDT:
    """The driver of ``config.boosting`` on ``device``."""
    name = config.boosting
    if name == "gbdt":
        return GBDT(config, train_data, objective, metrics, device)
    if name == "dart":
        from .dart import DART
        return DART(config, train_data, objective, metrics, device)
    if name == "goss":
        from .goss import GOSS
        return GOSS(config, train_data, objective, metrics, device)
    if name == "rf":
        from .rf import RF
        return RF(config, train_data, objective, metrics, device)
    raise LightGBMError("Unknown boosting type %s" % name)


__all__ = ["GBDT", "HostTree", "create_boosting"]
