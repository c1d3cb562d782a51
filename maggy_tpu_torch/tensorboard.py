"""Per-trial TensorBoard/metrics directory registry.

Capability parity with the reference ``maggy/tensorboard.py`` (tensorboard.py:
28-107): user code calls ``tensorboard.logdir()`` inside train_fn to get the
current trial's log directory, and the framework records hyperparameters per
trial. Differences forced by the execution model: executors are threads in
one process (not separate Spark processes), so the registry is thread-local;
and the event writer is optional — metrics always land in ``events.jsonl``,
and additionally in real TF event files when ``tensorboard`` is importable.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional

_local = threading.local()


def _env():
    from maggy_tpu_torch.core.env import EnvSing

    return EnvSing.get_instance()


def _register(logdir: str) -> None:
    """Called by the trial executor at trial start (reference tensorboard.py:28-44)."""
    _local.logdir = logdir
    _local.writer = None


def _unregister() -> None:
    writer = getattr(_local, "writer", None)
    if writer is not None:
        try:
            writer.close()
        except Exception:  # noqa: BLE001 - writer already broken; close is best-effort
            pass
    _local.logdir = None
    _local.writer = None


def logdir() -> str:
    """The current trial's log directory; raises outside a trial context."""
    d = getattr(_local, "logdir", None)
    if d is None:
        raise RuntimeError(
            "tensorboard.logdir() is only available inside a running trial."
        )
    return d


def write_hparams(hparams: Dict[str, Any], logdir: Optional[str] = None) -> None:
    """Persist the trial's hyperparameters (reference tensorboard.py:104-107).
    Goes through the Env abstraction so GCS experiment dirs work too. When the
    tensorboard package is available, additionally writes the HParams-plugin
    session-start summary so the trial shows as a session in the dashboard."""
    d = logdir or globals()["logdir"]()
    _env().dump(hparams, os.path.join(d, "hparams.json"))
    try:
        # NB: build the session-start proto by hand — the convenience module
        # tensorboard.plugins.hparams.summary imports all of tensorflow (~8s),
        # which would tax every experiment start; the raw protos are TF-free.
        from tensorboard.plugins.hparams import metadata, plugin_data_pb2

        info = plugin_data_pb2.SessionStartInfo(start_time_secs=time.time())
        for k, v in hparams.items():
            if isinstance(v, bool):
                info.hparams[k].bool_value = v
            elif isinstance(v, (int, float)):
                info.hparams[k].number_value = float(v)
            else:
                info.hparams[k].string_value = str(v)
        _write_tb_summary(
            d,
            _hparams_summary_pb(
                metadata.SESSION_START_INFO_TAG, session_start_info=info
            ),
        )
    except Exception:  # tensorboard absent / proto mismatch — json remains
        pass


def _hparams_summary_pb(tag: str, **plugin_fields):
    """One-tag Summary carrying HParamsPluginData (what the plugin's
    ``summary.experiment_pb``/``session_start_pb`` build, minus their
    tensorflow import)."""
    from tensorboard.compat.proto import summary_pb2
    from tensorboard.plugins.hparams import metadata, plugin_data_pb2

    data = plugin_data_pb2.HParamsPluginData(
        version=metadata.PLUGIN_DATA_VERSION, **plugin_fields
    )
    summ = summary_pb2.Summary()
    summ.value.add(
        tag=tag,
        metadata=summary_pb2.SummaryMetadata(
            plugin_data=summary_pb2.SummaryMetadata.PluginData(
                plugin_name=metadata.PLUGIN_NAME,
                content=data.SerializeToString(),
            )
        ),
    )
    return summ


def write_hparams_config(
    log_dir: str, searchspace, metrics=("metric",)
) -> bool:
    """Write the HParams plugin *experiment* config from a Searchspace so the
    TB HParams dashboard shows typed columns (reference tensorboard.py:47-102
    via tf.summary/hp.hparams_config; this is a pure-proto equivalent with no
    TF execution dependency). Returns False when tensorboard is unavailable."""
    try:
        from google.protobuf import struct_pb2
        from tensorboard.plugins.hparams import api_pb2, metadata
    except Exception:
        return False

    infos = []
    for key, typ in searchspace.names().items():
        vals = searchspace.get(key)
        if typ in ("DOUBLE", "INTEGER"):  # the plugin has no integer interval
            infos.append(
                api_pb2.HParamInfo(
                    name=key,
                    type=api_pb2.DATA_TYPE_FLOAT64,
                    domain_interval=api_pb2.Interval(
                        min_value=float(vals[0]), max_value=float(vals[1])
                    ),
                )
            )
        else:  # DISCRETE / CATEGORICAL
            domain = struct_pb2.ListValue()
            for v in vals:
                if isinstance(v, bool):
                    domain.values.add(bool_value=v)
                elif isinstance(v, (int, float)):
                    domain.values.add(number_value=float(v))
                else:
                    domain.values.add(string_value=str(v))
            if any(isinstance(v, str) for v in vals):
                dtype = api_pb2.DATA_TYPE_STRING
            elif all(isinstance(v, bool) for v in vals):
                dtype = api_pb2.DATA_TYPE_BOOL
            else:
                dtype = api_pb2.DATA_TYPE_FLOAT64
            infos.append(
                api_pb2.HParamInfo(name=key, type=dtype, domain_discrete=domain)
            )
    metric_infos = [
        api_pb2.MetricInfo(name=api_pb2.MetricName(tag=m)) for m in metrics
    ]
    experiment = api_pb2.Experiment(
        hparam_infos=infos,
        metric_infos=metric_infos,
        time_created_secs=time.time(),
    )
    summ = _hparams_summary_pb(metadata.EXPERIMENT_TAG, experiment=experiment)
    return _write_tb_summary(log_dir, summ)


# TFRecord framing for event files, first-party: tensorboard's own
# EventFileWriter resolves its filesystem through tensorboard.compat.tf, which
# imports all of tensorflow (~8s) when TF is installed — an unacceptable tax on
# every experiment start, and forcing its pure-python stub instead would
# repoint tensorboard.compat for the whole process. The format is four fields
# per record: u64le length, masked crc32c(length), data, masked crc32c(data).

_CRC32C_TABLE = None


def _crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), table-driven; records here are tens of bytes."""
    global _CRC32C_TABLE
    if _CRC32C_TABLE is None:
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            table.append(c)
        _CRC32C_TABLE = table
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC32C_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> bytes:
    import struct

    crc = _crc32c(data)
    masked = ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF
    return struct.pack("<I", masked)


def _tfrecord(data: bytes) -> bytes:
    import struct

    length = struct.pack("<Q", len(data))
    return length + _masked_crc(length) + data + _masked_crc(data)


def _write_tb_summary(log_dir: str, summary) -> bool:
    """Append one Summary proto to an event file in ``log_dir``. Goes through
    the Env seam, so remote (gs://) experiment dirs work without tensorflow."""
    try:
        import socket

        from tensorboard.compat.proto import event_pb2

        event = event_pb2.Event(wall_time=time.time())
        # the hparams protos may come from TF's descriptor pool; same wire
        # format, so serialize/parse across
        event.summary.ParseFromString(summary.SerializeToString())
        version = event_pb2.Event(
            wall_time=time.time(), file_version="brain.Event:2"
        )
        import uuid

        # unique per call with no shared counter: executors are threads in one
        # process, and a racy counter + same-microsecond clock could collide
        path = os.path.join(
            log_dir,
            "events.out.tfevents.{:.6f}.{}.{}.mt".format(
                time.time(), socket.gethostname(), uuid.uuid4().hex[:8]
            ),
        )
        env = _env()
        env.mkdir(log_dir)
        with env.open_file(path, "wb") as f:
            f.write(_tfrecord(version.SerializeToString()))
            f.write(_tfrecord(event.SerializeToString()))
        return True
    except Exception:
        return False


def scalar(tag: str, value: float, step: int) -> None:
    """Log one scalar for the current trial: always to events.jsonl, and to TF
    event files when the tensorboard package is available."""
    d = logdir()
    with _env().open_file(os.path.join(d, "events.jsonl"), "a") as f:
        f.write(
            json.dumps(
                {"tag": tag, "value": float(value), "step": int(step), "ts": time.time()}
            )
            + "\n"
        )
    writer = getattr(_local, "writer", None)
    if writer is None:
        try:
            from tensorboard.summary.writer.event_file_writer import EventFileWriter  # noqa: F401
            from tensorboardX import SummaryWriter  # pragma: no cover

            writer = SummaryWriter(d)
        except Exception:
            writer = False  # probed once, unavailable
        _local.writer = writer
    if writer:
        try:  # pragma: no cover - only with tensorboardX installed
            writer.add_scalar(tag, float(value), int(step))
        except Exception:  # noqa: BLE001 - mirror is best-effort; json remains
            pass
