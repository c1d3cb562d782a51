"""Framework-wide constants.

Capability parity with the reference's ``maggy/constants.py`` (constants.py:23-27):
the set of types a ``train_fn`` may return and a metric may take.
"""

import os

import numpy as np


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ[name])
    except (KeyError, ValueError):
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ[name])
    except (KeyError, ValueError):
        return default


class USER_FCT:
    """Constraints on user-supplied training functions."""

    # A train_fn may return a scalar metric or a dict containing the
    # optimization key (reference constants.py:23-27).
    RETURN_TYPES = (float, int, np.number, dict)
    NUMERIC_TYPES = (float, int, np.number)


# Name of the metric file written next to an experiment's outputs.
METRIC_FILE = ".metric"
OUTPUTS_FILE = ".outputs.json"
HPARAMS_FILE = ".hparams.json"
TRIAL_FILE = "trial.json"
RESULT_FILE = "result.json"
EXPERIMENT_FILE = "experiment.json"

# RPC defaults. Retry count and backoff base take env overrides so a pod
# launcher can widen the reconnect window fleet-wide without code changes
# (docs/resilience.md); the actual per-attempt delay is jittered in
# core/rpc.py so workers never reconnect in lockstep after a driver blip.
RPC_BUFSIZE = 1 << 16
RPC_MAX_MESSAGE = 64 << 20  # 64 MiB hard cap on a single framed message
RPC_MAX_RETRIES = _env_int("MAGGY_TPU_RPC_MAX_RETRIES", 3)
RPC_RETRY_BASE = _env_float("MAGGY_TPU_RPC_RETRY_BASE", 0.2)  # seconds
RESERVATION_TIMEOUT = 600.0  # seconds (reference rpc.py:282-303)
POLL_INTERVAL = 0.05  # client suggestion-poll interval (reference uses 1s; we poll faster)
