"""lightgbm_tpu_torch.serving: shape-bucketed batch inference on the card.

The port of ``lightgbm_tpu/serving/``. It serves trained or loaded models
under concurrent traffic with no CUDA-graph capture after warmup, and each
response is the port's ``Booster.predict`` on the same rows, bit for bit:

- registry.py   boosters and model files -> immutable bundles on a device
- traversal.py  the flat-forest traversal (the default hot path)
- predictor.py  the predictor cache: power-of-two buckets, a CUDA graph
                an entry on the card
- batching.py   deadline-bounded micro-batch coalescing queue
- server.py     HTTP / stdin front-ends (``task=serve``)
- metrics.py    latency quantiles, cache and graph-capture counters

Entry points: ``python -m lightgbm_tpu_torch task=serve
input_model=model.txt`` (or ``python -m lightgbm_tpu_torch.serving
input_model=model.txt``); in process, a ServingEngine with boosters
registered through ``Booster.as_serving_bundle``. Both run on CUDA unless
the caller asks for the CPU (``device="cpu"``, ``device_type=cpu``).
"""
from .batching import MicroBatchQueue
from .metrics import ServingMetrics, backend_compile_count, latency_summary
from .predictor import ServingEngine, bucket_rows, bucket_sizes
from .registry import CheckpointWatcher, ModelBundle, ModelRegistry
from .server import ServingApp, build_app, make_server, run_server, serve_stdin
from .traversal import FlatForest, forest_scores_flat, pack_flat_forest

__all__ = [
    "CheckpointWatcher", "FlatForest", "MicroBatchQueue", "ModelBundle",
    "ModelRegistry", "ServingApp", "ServingEngine", "ServingMetrics",
    "backend_compile_count", "bucket_rows", "bucket_sizes", "build_app",
    "forest_scores_flat", "latency_summary", "make_server",
    "pack_flat_forest", "run_server", "serve_stdin",
]
