"""Environment abstraction — local filesystem implementation; the port's copy
of :mod:`maggy_tpu.core.env.base`.

Parity with the reference's L0 environment layer (core/environment/base.py:25-222):
file I/O behind a narrow interface, experiment-directory layout, and worker-count
discovery. The JAX package's GCS variant (core/env/gcs.py) is not ported
(ROADMAP queue 1 item 9).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, List, Optional

import torch
import torch.distributed as dist


class BaseEnv:
    """Local-filesystem environment."""

    def __init__(self, root: Optional[str] = None):
        self.root = root or os.environ.get(
            "MAGGY_TPU_LOG_ROOT", os.path.join(os.getcwd(), "experiment_log")
        )

    # ------------------------------------------------------------------ fs ops

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def mkdir(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def delete(self, path: str, recursive: bool = False) -> None:
        if not os.path.exists(path):
            return
        if os.path.isdir(path):
            if recursive:
                shutil.rmtree(path)
            else:
                os.rmdir(path)
        else:
            os.remove(path)

    def open_file(self, path: str, mode: str = "r"):
        if "w" in mode or "a" in mode:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        return open(path, mode)

    def dump(self, data: Any, path: str) -> None:
        """Write text or JSON-serializable data to a file."""
        with self.open_file(path, "w") as f:
            if isinstance(data, str):
                f.write(data)
            else:
                json.dump(data, f, sort_keys=True, default=str)

    def load_json(self, path: str) -> Any:
        with self.open_file(path, "r") as f:
            return json.load(f)

    def listdir(self, path: str) -> List[str]:
        return sorted(os.listdir(path)) if os.path.isdir(path) else []

    # ---------------------------------------------------------- experiment dirs

    def experiment_dir(self, app_id: str, run_id: int) -> str:
        d = os.path.join(self.root, app_id, str(run_id))
        self.mkdir(d)
        return d

    def trial_dir(self, app_id: str, run_id: int, trial_id: str) -> str:
        d = os.path.join(self.experiment_dir(app_id, run_id), trial_id)
        self.mkdir(d)
        return d

    # ---------------------------------------------------------- driver registry

    def driver_registry_path(self, app_id: str) -> str:
        # posixpath: correct for local linux paths AND gs:// URLs, so GcsEnv
        # inherits the registry unchanged
        import posixpath

        return posixpath.join(self.root, ".drivers", f"{app_id}.json")

    def register_driver(
        self,
        app_id: str,
        run_id: int,
        host: str,
        port: int,
        secret: Optional[str] = None,
        scope: str = "pod",
    ) -> None:
        """Advertise a running driver so pod workers and monitors can find it
        by app id — the storage-seam analogue of the reference registering its
        driver with the Hopsworks REST endpoint (environment/hopsworks.py:
        136-190 posts {hostIp, port, appId, secret} to /maggy/drivers). The
        record lives in the experiment root (same trust domain as
        logs/checkpoints, like the reference's registry).

        ``scope``: "pod" records bootstrap remote workers (host must be
        cross-host reachable); "local" records advertise a loopback address
        for same-host monitor auto-attach ONLY — worker discovery ignores
        them (a loopback record would poison cross-host bootstrap)."""
        import time

        record = {
            "app_id": app_id,
            "run_id": run_id,
            "host": host,
            "port": port,
            "scope": scope,
            "ts": time.time(),
        }
        if secret is not None:
            record["secret"] = secret
        self._atomic_dump(record, self.driver_registry_path(app_id))

    def list_drivers(self) -> List[dict]:
        """All registry records, newest first (for monitor auto-attach)."""
        import posixpath

        out = []
        d = posixpath.join(self.root, ".drivers")
        try:
            names = self.listdir(d)
        except OSError:  # GcsEnv.listdir raises for missing paths
            return out
        for name in names:
            if not name.endswith(".json") or ".tmp." in name:
                continue
            try:
                out.append(self.load_json(posixpath.join(d, name)))
            except (OSError, ValueError):
                continue
        return sorted(out, key=lambda r: r.get("ts", 0), reverse=True)

    def _atomic_dump(self, data: Any, path: str) -> None:
        """Publish a JSON record atomically: a concurrently-polling worker must
        see either no record or a complete one, never truncated JSON. Local
        FS: temp file + rename. (GcsEnv inherits plain dump — a GCS object PUT
        is already atomic at the object level.)"""
        tmp = f"{path}.tmp.{os.getpid()}"
        self.dump(data, tmp)
        os.replace(tmp, path)

    def lookup_driver(self, app_id: str) -> Optional[dict]:
        path = self.driver_registry_path(app_id)
        try:
            if not self.exists(path):
                return None
            return self.load_json(path)
        except (OSError, ValueError):
            return None

    def unregister_driver(self, app_id: str) -> None:
        try:
            self.delete(self.driver_registry_path(app_id))
        except OSError:
            pass

    # ---------------------------------------------------------- cluster info

    def num_devices(self) -> int:
        """Visible CUDA cards on this host (``CUDA_VISIBLE_DEVICES`` applies)."""
        return torch.cuda.device_count()

    def process_index(self) -> int:
        return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0

    def num_processes(self) -> int:
        return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
