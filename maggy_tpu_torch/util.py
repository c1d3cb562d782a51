"""Small helpers shared by the port's entry points: the device an entry
point runs on, seeded generators, and the JAX-free helpers of
:mod:`maggy_tpu.util` that the control plane calls (signature-based kwarg
injection, return-value validation and persistence, a progress bar, run-id
bookkeeping)."""

from __future__ import annotations

import inspect
import json
import logging
import time
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from maggy_tpu_torch import constants, exceptions


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. With no device given and no CUDA present this raises; it never
    drops to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


def seed_everything(
    seed: int, device: Optional[Union[str, torch.device]] = None
) -> Tuple[np.random.Generator, torch.Generator]:
    """A seeded numpy Generator and a seeded ``torch.Generator`` on
    ``device`` (resolved as :func:`resolve_device` does). Nothing global is
    seeded: callers pass the generators where randomness is drawn."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return np.random.default_rng(seed), gen


def inject_kwargs(fn: Callable, available: Dict[str, Any]) -> Dict[str, Any]:
    """Inspect ``fn``'s signature and return only the kwargs it asks for.

    This is the mechanism behind the "oblivious training function": the same
    ``train_fn`` may request any subset of ``{model, dataset, hparams, reporter,
    mesh, train_ctx, ...}`` and runs unchanged in every execution mode
    (reference trial_executor.py:166-179).
    """
    sig = inspect.signature(fn)
    params = sig.parameters
    fn_name = getattr(fn, "__name__", "train_fn")
    # positional-only params can never be injected (we always call with
    # keywords), whether or not the name matches something available
    pos_only = [
        n for n, p in params.items() if p.kind == inspect.Parameter.POSITIONAL_ONLY
    ]
    if pos_only:
        raise exceptions.BadArgumentsError(
            fn_name,
            f"has positional-only parameter(s) {pos_only}; the framework "
            "injects arguments by keyword — drop the '/' marker.",
        )
    missing = [
        name
        for name, p in params.items()
        if p.default is inspect.Parameter.empty
        and p.kind
        in (inspect.Parameter.POSITIONAL_OR_KEYWORD, inspect.Parameter.KEYWORD_ONLY)
        and name not in available
    ]
    if missing:
        raise exceptions.BadArgumentsError(
            fn_name,
            f"asks for parameter(s) {missing} the framework does not inject "
            f"here; available: {sorted(available)}.",
        )
    if any(p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values()):
        return dict(available)
    return {k: v for k, v in available.items() if k in params}


def normalize_return_val(
    return_val: Any,
    optimization_key: str,
    require_metric: bool = True,
) -> tuple:
    """Map a train_fn return value to ``(metric, outputs)``.

    Numeric returns are used directly; dict returns must contain the
    optimization key with a numeric value. ``require_metric=False``
    (evaluator role: free-form evaluation outputs) additionally accepts dicts
    without the key, non-dict non-numeric values (persisted as
    ``{"value": ...}``), and None — metric is then None.
    """
    if isinstance(return_val, constants.USER_FCT.NUMERIC_TYPES) and not isinstance(
        return_val, bool
    ):
        return float(return_val), {optimization_key: float(return_val)}
    if isinstance(return_val, dict):
        if optimization_key not in return_val:
            if require_metric:
                raise exceptions.ReturnTypeError(optimization_key, return_val)
            return None, return_val
        metric = return_val[optimization_key]
        if not isinstance(metric, constants.USER_FCT.NUMERIC_TYPES) or isinstance(
            metric, bool
        ):
            raise exceptions.MetricTypeError(optimization_key, metric)
        return float(metric), return_val
    if not require_metric:
        # free-form evaluation artifacts (lists, strings, None) persist as-is
        return None, ({} if return_val is None else {"value": return_val})
    raise exceptions.ReturnTypeError(optimization_key, return_val)


def persist_outputs(
    outputs: dict, metric: Optional[float], log_dir: Optional[str]
) -> None:
    """Write ``.outputs.json`` (+ ``.metric`` when one exists) into a trial/
    worker dir; best-effort. Routed through the env seam so remote roots
    (gs://, memory://) receive the artifacts instead of a literal local
    'gs:/...' directory."""
    if not log_dir:
        return
    import posixpath

    from maggy_tpu_torch.core.env import EnvSing

    env = EnvSing.get_instance()
    try:
        env.mkdir(log_dir)
        env.dump(
            json.dumps(_jsonify(outputs), sort_keys=True),
            posixpath.join(log_dir, constants.OUTPUTS_FILE),
        )
        if metric is not None:
            env.dump(repr(metric), posixpath.join(log_dir, constants.METRIC_FILE))
    except Exception as e:  # noqa: BLE001 - cloud FS raise non-OSError types
        logging.getLogger(__name__).warning(
            "Could not persist trial outputs to %s: %s", log_dir, e
        )


def handle_return_val(
    return_val: Any,
    log_dir: Optional[str],
    optimization_key: str,
    log_file: Optional[str] = None,
    require_metric: bool = True,
) -> Optional[float]:
    """Validate a train_fn return value and persist outputs (reference
    util.py:159-199): :func:`normalize_return_val` + :func:`persist_outputs`."""
    metric, outputs = normalize_return_val(return_val, optimization_key, require_metric)
    persist_outputs(outputs, metric, log_dir)
    return metric


def _jsonify(obj: Any) -> Any:
    """Best-effort conversion of numpy scalars, torch tensors and arrays for
    JSON dumps. A tensor on any device comes to the host first: numpy takes no
    CUDA tensor."""
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu()
        return obj.item() if obj.ndim == 0 else obj.tolist()
    if isinstance(obj, dict):
        return {str(k): _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if hasattr(obj, "item") and getattr(obj, "ndim", None) == 0:
        return obj.item()
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return repr(obj)


def progress_bar(done: int, total: int, width: int = 30) -> str:
    """ASCII progress bar (reference util.py:79-94)."""
    total = max(total, 1)
    frac = min(done / total, 1.0)
    filled = int(width * frac)
    return "[" + "=" * filled + ">" + "-" * (width - filled) + f"] {done}/{total}"


def new_app_id() -> str:
    """Fabricate an application id in the reference's format
    (experiment_python.py:71-72)."""
    return "application_{}_0001".format(int(time.time()))


class RunRegistry:
    """Per-process experiment run-id bookkeeping (reference util.py:216-290)."""

    def __init__(self):
        self._run_ids: Dict[str, int] = {}

    def next_run_id(self, app_id: str) -> int:
        rid = self._run_ids.get(app_id, 0) + 1
        self._run_ids[app_id] = rid
        return rid

    def observe(self, app_id: str, run_id: int) -> None:
        """Record an externally-assigned run id (env-pinned by the elastic
        launcher) so later next_run_id calls continue after it."""
        self._run_ids[app_id] = max(self._run_ids.get(app_id, 0), int(run_id))


RUNS = RunRegistry()
