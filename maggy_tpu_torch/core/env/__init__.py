"""Environment singleton (reference core/environment/singleton.py:20-62); the
port's copy of :mod:`maggy_tpu.core.env`.

Selection: the local filesystem under ``MAGGY_TPU_LOG_ROOT``. A root with a
URL scheme (``gs://``, ``memory://``) or ``MAGGY_TPU_ENV=gcs`` selects the
JAX package's cloud environment, which the port lacks (ROADMAP queue 1
item 9): it raises.
"""

from __future__ import annotations

import os
from typing import Optional

from maggy_tpu_torch.core.env.base import BaseEnv

_instance: Optional[BaseEnv] = None


def get_instance() -> BaseEnv:
    global _instance
    if _instance is None:
        root = os.environ.get("MAGGY_TPU_LOG_ROOT", "")
        # any URL scheme routes through fsspec (incl. file:// — fsspec's
        # local driver handles it; BaseEnv would treat it as a literal path)
        if "://" in root or os.environ.get("MAGGY_TPU_ENV") == "gcs":
            raise NotImplementedError(
                f"log root {root!r}: the cloud environment (core/env/gcs.py) is "
                "ROADMAP queue 1 item 9, not ported yet; use a local path"
            )
        _instance = BaseEnv(root or None)
    return _instance


def set_instance(env: Optional[BaseEnv]) -> None:
    """Override the ambient environment (used by tests and embedding apps)."""
    global _instance
    _instance = env


class EnvSing:
    """Reference-shaped accessor (singleton.py:20-62)."""

    @staticmethod
    def get_instance() -> BaseEnv:
        return get_instance()
