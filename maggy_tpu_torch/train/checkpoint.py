"""Checkpointing and experiment resume.

Counterpart of :mod:`maggy_tpu.train.checkpoint`, with orbax replaced by
``torch.save``:

* :class:`Checkpointer` — async save and restore of a
  :class:`~maggy_tpu_torch.train.trainer.TrainState` into a trial directory,
  with the JAX package's API and JSON sidecar meta.
* :func:`restore_zero_compat` — the ZeRO-aware restore ``fit(resume=...)``
  goes through: dense to ZeRO-1 and back, and ZeRO-1 across a change of
  ``data`` width or ``bucket_mb``, converting the optimizer state as JAX's
  does.
* experiment resume — :func:`load_finalized_trials` preloads a previous
  experiment's persisted ``trial.json`` records.

On disk, under the checkpointer's directory::

    <step>/state.pt            # torch.save({"step", "params", "optimizer"})
    system_meta/<step>.json    # Trainer.checkpoint_meta() at save time

``params`` is the model's ``named_parameters()`` in order; ``optimizer`` is
the optimizer's full ``state_dict()`` (each parameter's moments and its
``step`` tensor, which bias correction reads, and the param-group
hyperparameters), whose state is keyed by parameter order — so a restore
into a trainer built the same way puts every value back where it was.
Under ZeRO-1 (``meta["zero"]["stage"] == 1``) the optimizer's state is
JAX's flat layout instead: keyed by bucket, each moment the bucket's whole
flat padded vector (:mod:`maggy_tpu_torch.parallel.overlap`).

Under a mesh (a model whose parameters are DTensors, laid out by
``Trainer.make_state``, or a bucketed or ZeRO-1 state, whose
``TrainState.layout`` is set) the checkpoint is rank 0's: ``save``, ``wait``,
``close`` and ``restore`` are collectives that every rank calls at the
same point, and every decision in them is rank 0's, taken on rank 0's
directory and sent to the others (:func:`~maggy_tpu_torch.parallel.mesh.from_rank0`),
so ranks whose checkpointers name other directories (each rank's own
``trial_dir``) still agree. A save gathers full state dicts
(``torch.distributed.checkpoint.state_dict``, ``full_state_dict=True,
cpu_offload=True``) on every rank, and rank 0 writes them in the same
format, so a checkpoint is the same file whatever the mesh; every rank
learns whether rank 0's write committed at the next save, ``wait`` or
``close`` (within the host group's ``PROCESS_GROUP_TIMEOUT_S``). A
restore under a mesh loads the file on rank 0 only and broadcasts it
(``broadcast_from_rank0=True``; a bucketed or ZeRO-1 state takes each
tensor by ``broadcast``), each rank keeping its shards: a
checkpoint moves between meshes, and between a mesh and one device, as
orbax's restore does in the JAX package.

Under pp (a state whose ``TrainState.pipeline`` is set: each rank holds one
pipeline stage) a save gathers every stage's parameters and AdamW moments
to rank 0 over the host group (:func:`~maggy_tpu_torch.train.
pipeline_adapter.stage_state` on each stage, tensor shards gathered
first), and rank 0 writes the whole Decoder's state in the one-device
format; a restore has rank 0 read it and send each rank its stage's share.
So a pp checkpoint restores onto another pp degree, onto pp x tp and onto
one device, and a one-device checkpoint onto pp.

Under ``expert`` (an ``MoEDecoder`` whose ranks hold ``n_experts / ep``
experts each) the full state dicts hold a rank's own experts only: a save
gathers each expert weight and its moments over ``expert`` too, so rank 0
writes them whole, ``[experts, ...]``, in the one-device format; a restore
broadcasts rank 0's whole tensors and each rank keeps its experts' share.
Under ``tensor`` the expert weights' hidden columns are gathered with the
other DTensors' shards first; a pipeline stage's experts are gathered and
cut by :func:`~maggy_tpu_torch.train.pipeline_adapter.stage_state` and
``load_stage_state``, so a pp x ep or pp x tp checkpoint restores on one
device and onto any other layout of the same model.

A save commits atomically, as orbax's does: the step is written into a
temporary directory whose name is not a step number, its file and the
directory are fsync'd, the directory is renamed to ``<step>`` and the parent
fsync'd, and only then are older steps pruned to ``max_to_keep``. A process
killed mid-save leaves the previous step as :meth:`Checkpointer.latest_step`;
the leftover temporary directory is ignored, and removed by the next
checkpointer opened on the directory.

Async means the training loop blocks only for the copy of every tensor into
host buffers (kept across saves, so each save after the first reuses them);
the file write runs on a thread, which the next :meth:`Checkpointer.save` or
:meth:`Checkpointer.wait` joins. It is not a daemon thread: an interpreter
that exits right after a save waits for it to commit. A restore loads with
``torch.load(weights_only=True, mmap=True)`` and copies each tensor straight
from the mapped file into the live one: the host holds no second copy and
nothing is staged on the card.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import warnings
from typing import Any, Dict, List, Optional

import torch

# sidecar directory (non-numeric name: invisible to the step scan) holding
# one JSON per step with the system config the state was saved under
_META_DIR = "system_meta"
_STATE_FILE = "state.pt"
_TMP_MARK = ".tmp-"


def _fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class Checkpointer:
    """Save and restore TrainStates under one directory (per trial or per run)."""

    def __init__(self, directory: str, max_to_keep: int = 3, async_save: bool = True):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        self.async_save = async_save
        self._dist_pending = False  # under a mesh: every rank still awaits rank 0's commit
        os.makedirs(self.directory, exist_ok=True)
        for name in os.listdir(self.directory):  # an interrupted save's leftovers
            if _TMP_MARK in name:
                shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)
        self._host: Dict[Any, torch.Tensor] = {}  # reused host buffers, by tensor slot
        self._writer: Optional[threading.Thread] = None
        self._write_error: Optional[BaseException] = None
        self._writing: Optional[int] = None  # the step the writer thread commits

    # ------------------------------------------------------------------ save

    def _to_host(self, key, t: torch.Tensor) -> torch.Tensor:
        buf = self._host.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = self._host[key] = torch.empty(t.shape, dtype=t.dtype, device="cpu")
        buf.copy_(t.detach())
        return buf

    def _snapshot(self, step: int, state: Any) -> Dict[str, Any]:
        """Host copies of the state's tensors, in the buffers kept for them."""
        params = {
            name: self._to_host(("p", name), p)
            for name, p in state.model.named_parameters()
        }
        osd = state.optimizer.state_dict()
        opt_state = {
            idx: {
                k: self._to_host(("o", idx, k), v) if isinstance(v, torch.Tensor) else v
                for k, v in per_param.items()
            }
            for idx, per_param in osd["state"].items()
        }
        return {
            "step": int(step),
            "params": params,
            "optimizer": {"state": opt_state, "param_groups": osd["param_groups"]},
        }

    def save(self, step: int, state: Any, meta: Optional[Dict[str, Any]] = None) -> None:
        """Save ``state`` at ``step``. ``meta`` — the active system config
        (``Trainer.checkpoint_meta()``) — is recorded in a JSON sidecar so a
        later restore can warn when the live configuration differs from the
        one that wrote the checkpoint. Returns once the state is copied to
        host memory; the write commits in the background unless the
        checkpointer was made with ``async_save=False``. A step that is
        already saved, or being written, is not saved again (as orbax's
        manager skips it)."""
        from maggy_tpu_torch import telemetry

        tel = telemetry.get()
        step = int(step)
        if _collective(state):
            return self._save_sharded(step, state, meta, tel)
        if (self._writer is not None and self._writing == step) or step in self.all_steps():
            if not self.async_save:
                self.wait()
            return
        self.wait()  # the previous write owns the host buffers until it commits
        t0 = time.perf_counter()
        with tel.span("checkpoint_save", step=step):
            payload = self._snapshot(step, state)
        nbytes = sum(b.numel() * b.element_size() for b in self._host.values())
        if meta is not None:
            self._write_meta(step, meta)
        self._writing = step
        self._writer = threading.Thread(
            target=self._write, args=(step, payload, nbytes, tel), name="maggy-checkpoint-writer"
        )
        self._writer.start()
        if not self.async_save:
            self.wait()
        # the blocking cost: what a save steals from the step time
        tel.gauge("checkpoint_save_ms", (time.perf_counter() - t0) * 1e3)

    def _save_sharded(self, step: int, state: Any, meta: Optional[Dict[str, Any]], tel: Any) -> None:
        """A save under a mesh: every rank joins the gather of the full
        state dicts; rank 0 writes them. Whether the step is saved already
        is rank 0's answer."""
        import torch.distributed as dist

        from maggy_tpu_torch.parallel.mesh import from_rank0

        self.wait()  # every rank: the last save has committed
        if from_rank0(step in self.all_steps() if dist.get_rank() == 0 else None):
            return
        t0 = time.perf_counter()
        with tel.span("checkpoint_save", step=step):
            payload = _full_payload(step, state)
        self._dist_pending = True
        if dist.get_rank() == 0:
            nbytes = sum(t.numel() * t.element_size() for t in _tensors(payload))
            if meta is not None:
                self._write_meta(step, meta)
            self._writing = step
            self._writer = threading.Thread(
                target=self._write, args=(step, payload, nbytes, tel), name="maggy-checkpoint-writer"
            )
            self._writer.start()
        if not self.async_save:
            self.wait()
        tel.gauge("checkpoint_save_ms", (time.perf_counter() - t0) * 1e3)

    def _write(self, step: int, payload: Dict[str, Any], nbytes: int, tel: Any) -> None:
        """The writer thread: commit ``payload`` as ``step``. The
        ``checkpoint_commit`` span (the write, fsyncs and rename, with the
        bytes written) goes to the recorder that was current at ``save``."""
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory, f"{step}{_TMP_MARK}{os.getpid()}-{time.monotonic_ns()}")
        try:
            with tel.span("checkpoint_commit", step=step, bytes=nbytes):
                os.makedirs(tmp)
                path = os.path.join(tmp, _STATE_FILE)
                torch.save(payload, path)
                _fsync(path)
                _fsync(tmp)
                if os.path.exists(final):  # a bare step directory without its file: not a step
                    shutil.rmtree(final)
                os.rename(tmp, final)
                _fsync(self.directory)
            self._prune()
        except BaseException as e:  # noqa: BLE001 - raised by the next wait()
            shutil.rmtree(tmp, ignore_errors=True)
            self._write_error = e  # race: ok — wait() reads it only after join()

    def _prune(self) -> None:
        for old in self.all_steps()[: -self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)

    def wait(self) -> None:
        """Block until the last save has committed; raise its error if the
        write failed."""
        writer, self._writer = self._writer, None
        if writer is not None:
            writer.join()
        err, self._write_error = self._write_error, None  # race: ok — the writer has joined
        pending, self._dist_pending = self._dist_pending, False
        if pending:
            err = _agree_on_commit(err)
        if err is not None:
            raise RuntimeError(f"checkpoint write under {self.directory} failed") from err

    def close(self) -> None:
        """Wait for the last save and release the host buffers."""
        try:
            self.wait()
        finally:
            self._host.clear()

    # ------------------------------------------------------------------ meta

    def _meta_path(self, step: int) -> str:
        return os.path.join(self.directory, _META_DIR, f"{int(step)}.json")

    def _write_meta(self, step: int, meta: Dict[str, Any]) -> None:
        from maggy_tpu_torch.util import _jsonify

        path = self._meta_path(step)
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as f:
                json.dump(_jsonify(meta), f, sort_keys=True)
        except OSError:
            pass  # metadata is advisory; never fail a save over it

    def saved_meta(self, step: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """The system-config metadata recorded with ``step`` (default:
        latest), or None for checkpoints saved without it."""
        step = int(step) if step is not None else self.latest_step()
        if step is None:
            return None
        try:
            with open(self._meta_path(step)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    # the layout keys get their own counter: a restore across world sizes
    _LAYOUT_KEYS = ("mesh_axes", "num_devices", "n_processes")

    def _check_meta(self, step: int, expect_meta: Dict[str, Any]) -> None:
        """Warn (never fail) when the checkpoint's recorded system config
        disagrees with the live one on any shared key, and count a
        ``resilience.ckpt_reshards`` when the layout differs."""
        from maggy_tpu_torch import telemetry
        from maggy_tpu_torch.util import _jsonify

        saved = self.saved_meta(step)
        if not saved or not expect_meta:
            return
        expect = _jsonify(expect_meta)
        keys = [k for k in sorted(set(saved) & set(expect)) if saved[k] != expect[k]]
        if set(keys) & set(self._LAYOUT_KEYS):
            telemetry.get().count("resilience.ckpt_reshards")
        diffs = [f"{k}: saved={saved[k]!r} live={expect[k]!r}" for k in keys]
        if diffs:
            warnings.warn(
                f"checkpoint step {step} was saved under a different system "
                f"config than the live one ({'; '.join(diffs)}); the state "
                "is restored onto the live devices, but training dynamics "
                "(batch/microbatch semantics) may differ",
                stacklevel=3,
            )

    # --------------------------------------------------------------- restore

    def _load(self, step: int) -> Dict[str, Any]:
        path = os.path.join(self.directory, str(step), _STATE_FILE)
        return torch.load(path, map_location="cpu", weights_only=True, mmap=True)

    def restore(
        self,
        state_template: Any,
        step: Optional[int] = None,
        expect_meta: Optional[Dict[str, Any]] = None,
        *,
        convert=None,
    ) -> Any:
        """Restore into the live ``state_template`` (a ``TrainState`` from
        ``Trainer.make_state``), in place, and return it: every parameter,
        the optimizer's state and hyperparameters, and the step. Tensors
        land on the devices the live ones are on. Pass the live trainer's
        ``checkpoint_meta()`` as ``expect_meta`` to be warned when the
        checkpoint was written under a different configuration.

        Fallback: when no explicit ``step`` was requested and the latest
        retained step is unreadable, older retained steps are tried
        newest-first — each skip warns and counts a ``checkpoint_fallback``.
        An explicitly requested step never falls back.

        ``convert`` (what :func:`restore_zero_compat` passes) rewrites the
        loaded payload before it is copied in (on rank 0 under a mesh)."""
        from maggy_tpu_torch import telemetry

        if _collective(state_template):
            return self._restore_sharded(state_template, step, expect_meta, convert)
        explicit = step is not None
        candidates = self._candidates(step)
        for i, s in enumerate(candidates):
            if expect_meta is not None:
                self._check_meta(s, expect_meta)
            try:
                payload = self._load(s)
                if convert is not None:
                    payload = convert(payload)
            # a truncated or corrupt file surfaces as several types (zip,
            # unpickling, OS errors): anything but success means "this step
            # is gone"
            except Exception as e:  # noqa: BLE001
                if explicit or i == len(candidates) - 1:
                    raise
                telemetry.get().count("checkpoint_fallback")
                warnings.warn(
                    f"checkpoint step {s} under {self.directory} is "
                    f"unreadable ({type(e).__name__}: {e}); falling back to "
                    f"the previous retained step {candidates[i + 1]}",
                    stacklevel=2,
                )
                continue
            with telemetry.get().span("checkpoint_restore", step=s):
                _copy_into(state_template, payload)
            return state_template
        raise FileNotFoundError(f"No checkpoint found under {self.directory}")

    def _candidates(self, step: Optional[int]) -> List[int]:
        """The steps a restore tries, in order: ``step`` alone when asked
        for, else every retained step newest first."""
        if step is not None:
            return [int(step)]
        steps = self.all_steps()[::-1]
        if not steps:
            raise FileNotFoundError(f"No checkpoint found under {self.directory}")
        return steps

    def _restore_sharded(self, state: Any, step: Optional[int], expect_meta: Optional[Dict[str, Any]],
                         convert=None) -> Any:
        """A restore under a mesh: rank 0 picks the step and reads the file
        (falling back to older steps as :meth:`restore` does) and
        broadcasts it; every rank keeps its shards and raises what rank 0
        raised."""
        import torch.distributed as dist
        from torch.distributed.checkpoint.state_dict import (
            StateDictOptions,
            set_model_state_dict,
            set_optimizer_state_dict,
        )

        from maggy_tpu_torch import telemetry
        from maggy_tpu_torch.parallel.mesh import from_rank0

        model_sd: Dict[str, Any] = {}
        optim_sd: Dict[str, Any] = {}
        payload = shares = None
        status = None
        if dist.get_rank() == 0:
            try:
                candidates = self._candidates(step)
            except FileNotFoundError as e:
                candidates, status = [], ("missing", str(e))
            for i, s in enumerate(candidates):
                if expect_meta is not None:
                    self._check_meta(s, expect_meta)
                try:
                    payload = self._load(s)
                    if convert is not None:
                        payload = convert(payload)
                    if getattr(state, "pipeline", None) is not None:
                        shares = _pipeline_shares(state, payload)
                    elif getattr(state, "layout", None) is None:
                        model_sd, optim_sd = _fqn_state_dicts(state, payload)
                    else:  # broadcast as it is below
                        _check_params(state, payload["params"])
                    status = ("ok", int(payload["step"]))
                    break
                except Exception as e:  # noqa: BLE001 - unreadable or mismatched: as restore()
                    if step is not None or i == len(candidates) - 1 or isinstance(e, ValueError):
                        status = ("error", f"{type(e).__name__}: {e}")
                        break
                    telemetry.get().count("checkpoint_fallback")
                    warnings.warn(
                        f"checkpoint step {s} under {self.directory} is unreadable ({type(e).__name__}: "
                        f"{e}); falling back to the previous retained step {candidates[i + 1]}",
                        stacklevel=3,
                    )
        kind, value = from_rank0(status)
        if kind == "missing":
            raise FileNotFoundError(value)
        if kind != "ok":
            raise ValueError(f"restore failed on rank 0: {value}")
        if getattr(state, "pipeline", None) is not None:  # each rank its stage's share
            from maggy_tpu_torch.parallel.mesh import host_group
            from maggy_tpu_torch.train.pipeline_adapter import load_stage_state

            share = [None]
            dist.scatter_object_list(share, shares, src=0, group=host_group())
            with telemetry.get().span("checkpoint_restore", step=value):
                load_stage_state(state, share[0])
            return state
        if getattr(state, "layout", None) is not None:  # plain tensors, replicated or flat-sharded
            with telemetry.get().span("checkpoint_restore", step=value):
                _copy_layout(state, _broadcast_tree(payload, next(state.model.parameters()).device))
            return state
        # two calls: set_state_dict would read the other ranks' empty model
        # dict as "optimizer only" and skip the model's broadcast
        options = StateDictOptions(full_state_dict=True, broadcast_from_rank0=True)
        experts = _first_experts(state, model_sd, optim_sd) if dist.get_rank() == 0 else {}
        with telemetry.get().span("checkpoint_restore", step=value):
            set_model_state_dict(state.model, model_sd, options=options)
            set_optimizer_state_dict(state.model, state.optimizer, optim_sd, options=options)
            _scatter_experts(state, experts)
        state.step = value
        return state

    def restore_params(self, step: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Params-only restore for serving: the saved ``named_parameters()``
        as a ``state_dict`` of host tensors mapped from the file — what
        ``model.load_state_dict`` takes — without building an optimizer."""
        from maggy_tpu_torch import telemetry

        step = int(step) if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"No checkpoint found under {self.directory}")
        with telemetry.get().span("checkpoint_restore_params", step=step):
            payload = self._load(step)
        if "params" not in payload:
            raise ValueError(
                f"checkpoint at step {step} has no 'params' (keys: {sorted(payload)})"
            )
        return dict(payload["params"])

    def all_steps(self) -> List[int]:
        """Committed steps, oldest first."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(
            int(name) for name in os.listdir(self.directory)
            if name.isdigit() and os.path.isfile(os.path.join(self.directory, name, _STATE_FILE))
        )

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None


def _collective(state) -> bool:
    """Whether a save or restore of ``state`` is a collective of its mesh:
    its parameters are DTensors, or it is a bucketed, ZeRO-1 or pipeline
    state."""
    return (_sharded(state.model) or getattr(state, "layout", None) is not None
            or getattr(state, "pipeline", None) is not None)


def _sharded(model) -> bool:
    """Whether ``model``'s parameters are laid out on a mesh (DTensors)."""
    import sys

    dtensor = sys.modules.get("torch.distributed.tensor")  # loaded wherever a DTensor exists
    return dtensor is not None and any(isinstance(p, dtensor.DTensor) for p in model.parameters())


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _full_payload(step: int, state: Any) -> Optional[Dict[str, Any]]:
    """The checkpoint of a state laid out on a mesh, in the one-device
    format: the full parameters in ``named_parameters()`` order and the
    optimizer's state keyed by parameter index (by bucket, each moment the
    bucket's whole flat vector, under ZeRO-1), on the host of rank 0 (the
    other ranks take part in the gather and get None)."""
    import torch.distributed as dist
    from torch.distributed.checkpoint.state_dict import StateDictOptions, get_state_dict

    if getattr(state, "layout", None) is not None:
        return _layout_payload(step, state)
    if getattr(state, "pipeline", None) is not None:
        return _pipeline_payload(step, state)
    model_sd, optim_sd = get_state_dict(
        state.model, state.optimizer, options=StateDictOptions(full_state_dict=True, cpu_offload=True)
    )
    experts = _gather_experts(state)
    if dist.get_rank() != 0:
        return None
    for name, (param, moments) in experts.items():
        model_sd[name] = param
        optim_sd["state"][name].update(moments)
    names = [name for name, _ in state.model.named_parameters()]
    index = {name: i for i, name in enumerate(names)}
    return {
        "step": int(step),
        "params": {name: model_sd[name] for name in names},
        "optimizer": {
            "state": {index[name]: values for name, values in optim_sd["state"].items()},
            "param_groups": [
                {**group, "params": [index[name] for name in group["params"]]}
                for group in optim_sd["param_groups"]
            ],
        },
    }


def _expert_tensors(state: Any):
    """``(name, parameter, {moment: tensor}, placement)`` of each MoE expert
    weight sharded over ``expert``, with its AdamW moments."""
    from maggy_tpu_torch.parallel.expert import expert_params

    for name, (p, place) in expert_params(state.model).items():
        moments = {k: v for k, v in state.optimizer.state.get(p, {}).items()
                   if isinstance(v, torch.Tensor) and v.dim() > 0}
        yield name, p, moments, place


def _gather_experts(state: Any) -> Dict[str, Any]:
    """Every expert weight sharded over ``expert``, and its moments, whole
    (``[experts, ...]``) on rank 0's host: ``{name: (parameter, {moment:
    tensor})}``; the other ranks take part and get ``{}``. A full state
    dict holds a rank's own experts only."""
    import torch.distributed as dist

    from maggy_tpu_torch.parallel.expert import gather_expert_tensor

    out = {}
    for name, p, moments, place in _expert_tensors(state):
        whole = {k: gather_expert_tensor(v, place) for k, v in [("param", p), *moments.items()]}
        if dist.get_rank() == 0:
            whole = {k: v.cpu() for k, v in whole.items()}
            out[name] = (whole.pop("param"), whole)
    return out


def _first_experts(state: Any, model_sd: Dict[str, Any], optim_sd: Dict[str, Any]) -> Dict[str, Any]:
    """On rank 0 before a restore under ``expert``: the whole expert
    tensors of the loaded state dicts, taken out (``{name: {"param" or
    moment: tensor}}``) and replaced by the shapes a rank holds (the first
    rank's experts), so the state dicts fit the live model."""
    out = {}
    for name, _, _, place in _expert_tensors(state):
        if name not in model_sd:
            continue
        n = model_sd[name].shape[0] // place.ep
        whole = {"param": model_sd[name]}
        model_sd[name] = model_sd[name][:n]
        for k, v in optim_sd["state"].get(name, {}).items():
            if isinstance(v, torch.Tensor) and v.dim() > 0:
                whole[k] = v
                optim_sd["state"][name][k] = v[:n]
        out[name] = whole
    return out


def _scatter_experts(state: Any, whole: Dict[str, Any]) -> None:
    """After a restore under ``expert``: rank 0's whole expert tensors
    (``_first_experts``) broadcast, and each rank's share copied into its
    parameters and moments."""
    from maggy_tpu_torch.parallel.expert import scatter_expert_tensor

    tensors = list(_expert_tensors(state))
    if not tensors:
        return
    first = tensors[0][1]
    whole = _broadcast_tree(whole, (first.to_local() if hasattr(first, "to_local") else first).device)
    for name, p, moments, place in tensors:
        for k, dst in [("param", p), *moments.items()]:
            scatter_expert_tensor(dst, whole[name][k], place)
        del whole[name]


def _pipeline_payload(step: int, state: Any) -> Optional[Dict[str, Any]]:
    """:func:`_full_payload` of a pipeline state: every stage's whole
    parameters and optimizer state, gathered to rank 0 over the host group
    from the first rank of each stage and merged in the Decoder's order."""
    import torch.distributed as dist

    from maggy_tpu_torch.parallel.mesh import host_group
    from maggy_tpu_torch.train.pipeline_adapter import stage_state

    pipe = state.pipeline
    part = stage_state(state)  # every rank: the tensor shards are gathered
    rank0 = dist.get_rank() == 0
    gathered = [None] * dist.get_world_size() if rank0 else None
    dist.gather_object((pipe.stage, part) if pipe.leader else None, gathered, dst=0, group=host_group())
    if not rank0:
        return None
    stages = dict(g for g in gathered if g is not None)
    parts = pipe.parts
    params = parts.unstack([stages[s]["params"] for s in range(parts.n_stages)])
    optim = parts.unstack([stages[s]["optimizer"] for s in range(parts.n_stages)])
    names = list(params)
    return {
        "step": int(step),
        "params": params,
        "optimizer": {
            "state": {i: optim[n] for i, n in enumerate(names) if n in optim},
            "param_groups": [{**stages[0]["hyper"], "params": list(range(len(names)))}],
        },
    }


def _pipeline_shares(state: Any, payload: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Rank 0's split of a one-device payload into each global rank's
    stage (:func:`~maggy_tpu_torch.train.pipeline_adapter.stage_state`'s
    form); raises ValueError when it is not this Decoder's."""
    from maggy_tpu_torch.parallel.spec import AXIS_STAGE

    pipe = state.pipeline
    parts = pipe.parts
    names = list(payload["params"])
    want = {n: p.shape for s in range(parts.n_stages) for n, p in parts.make_stage(s, "meta").named_parameters()}
    if names != list(want) or any(tuple(payload["params"][n].shape) != tuple(want[n]) for n in names):
        raise ValueError(
            f"checkpoint parameters differ from the pipelined Decoder's (missing {sorted(set(want) - set(names))}, "
            f"unexpected {sorted(set(names) - set(want))}, or in another order or shape)"
        )
    osd = payload["optimizer"]
    optim = {names[int(i)]: v for i, v in osd["state"].items()}
    hyper = {k: v for k, v in osd["param_groups"][0].items() if k != "params"}
    shares = [{"step": int(payload["step"]), "params": p, "optimizer": o, "hyper": hyper}
              for p, o in zip(parts.restack(payload["params"]), parts.restack(optim))]
    ranks = pipe.mesh.mesh  # the global ranks, laid out over the mesh's axes
    axis = pipe.mesh.mesh_dim_names.index(AXIS_STAGE)
    stage_of_rank = {r: s for s in range(ranks.shape[axis]) for r in ranks.select(axis, s).flatten().tolist()}
    return [shares[stage_of_rank[r]] for r in range(ranks.numel())]


def _fqn_state_dicts(state: Any, payload: Dict[str, Any]):
    """A checkpoint's parameters and optimizer state keyed by parameter
    name, as ``set_state_dict`` takes them; raises ValueError when they do
    not fit the live model."""
    names = [name for name, _ in state.model.named_parameters()]
    saved = payload["params"]
    _check_params(state, saved)
    osd = payload["optimizer"]
    optim = {
        "state": {names[int(i)]: values for i, values in osd["state"].items()},
        "param_groups": [{**g, "params": [names[int(i)] for i in g["params"]]} for g in osd["param_groups"]],
    }
    return dict(saved), optim


@torch.no_grad()
def _layout_payload(step: int, state: Any) -> Optional[Dict[str, Any]]:
    """:func:`_full_payload` of a bucketed or ZeRO-1 state. Its parameters
    are whole on every rank; under ZeRO-1 each moment of each bucket is
    all-gathered from the ``data`` ranks' shards into the bucket's flat
    vector."""
    import torch.distributed as dist

    from maggy_tpu_torch.parallel import overlap

    layout = state.layout
    osd = state.optimizer.state_dict()
    opt_state = {}
    for j, per in osd["state"].items():
        out = {}
        for key, value in per.items():
            if layout.zero is not None and isinstance(value, torch.Tensor) and value.dim() == 1:
                full = torch.empty(layout.plan.buckets[j].padded_size, dtype=value.dtype, device=value.device)
                overlap.all_gather_flat(dist)(full, value.contiguous(), group=layout.group)
                value = full
            out[key] = value.cpu() if isinstance(value, torch.Tensor) else value
        opt_state[j] = out
    if dist.get_rank() != 0:
        return None
    return {
        "step": int(step),
        "params": {name: p.detach().cpu() for name, p in state.model.named_parameters()},
        "optimizer": {"state": opt_state, "param_groups": osd["param_groups"]},
    }


class _Slot:
    """A tensor's place in a broadcast tree: its shape and dtype."""

    def __init__(self, t: torch.Tensor):
        self.shape, self.dtype = tuple(t.shape), t.dtype


def _skeleton(tree):
    if isinstance(tree, torch.Tensor):
        return _Slot(tree)
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_skeleton(v) for v in tree]
    return tree


def _broadcast_tree(tree, device):
    """Rank 0's ``tree`` (dicts, lists, tensors, plain values) on every
    rank, each tensor broadcast on ``device``; every rank must call it."""
    import torch.distributed as dist

    from maggy_tpu_torch.parallel.mesh import from_rank0

    rank0 = dist.get_rank() == 0

    def fill(skel, mine):
        if isinstance(skel, _Slot):
            t = mine.to(device) if rank0 else torch.empty(skel.shape, dtype=skel.dtype, device=device)
            dist.broadcast(t, 0)
            return t
        if isinstance(skel, dict):
            return {k: fill(v, mine[k] if rank0 else None) for k, v in skel.items()}
        if isinstance(skel, list):
            return [fill(v, mine[i] if rank0 else None) for i, v in enumerate(skel)]
        return skel

    return fill(from_rank0(_skeleton(tree) if rank0 else None), tree)


def _copy_layout(state: Any, payload: Dict[str, Any]) -> None:
    """Copy a payload in this state's layout into a bucketed or ZeRO-1
    state: the parameters whole (under ZeRO-1 into the flat buffers they
    are views of), the optimizer's state as it is (bucket) or this rank's
    shard of each flat vector (ZeRO-1)."""
    layout = state.layout
    if layout.zero is None:
        _copy_into(state, payload)
        return
    osd = payload["optimizer"]
    mine = {}
    for j, per in osd["state"].items():
        n = layout.plan.buckets[int(j)].padded_size // layout.dz
        mine[int(j)] = {
            k: v[layout.rank * n:(layout.rank + 1) * n]
            if isinstance(v, torch.Tensor) and v.dim() == 1 and v.shape[0] == n * layout.dz else v
            for k, v in per.items()
        }
    _copy_params(state, payload)
    _copy_optimizer(state.optimizer, {"state": mine, "param_groups": osd["param_groups"]})
    state.step = int(payload["step"])


def _agree_on_commit(err: Optional[BaseException]) -> Optional[BaseException]:
    """Under a mesh, after a save: rank 0 sends whether its write committed,
    and every other rank takes rank 0's failure as its own."""
    import torch.distributed as dist

    from maggy_tpu_torch.parallel.mesh import from_rank0

    rank0 = dist.get_rank() == 0
    word = from_rank0(f"{type(err).__name__}: {err}" if rank0 and err is not None else None)
    if rank0 or word is None:
        return err
    return RuntimeError(f"rank 0's checkpoint write failed: {word}")


@torch.no_grad()
def _copy_into(state: Any, payload: Dict[str, Any]) -> None:
    """Copy a loaded checkpoint into a live TrainState: tensors that exist
    are overwritten in place; optimizer state a fresh optimizer has not made
    yet is made on its parameter's device."""
    _copy_params(state, payload)
    _copy_optimizer(state.optimizer, payload["optimizer"])
    state.step = int(payload["step"])


def _check_params(state: Any, saved: Dict[str, Any]) -> None:
    """Raise ValueError unless a checkpoint's parameters are the live
    model's, by name, order and shape (a DTensor by its global shape, an
    expert weight sharded over ``expert`` by all its experts)."""
    from maggy_tpu_torch.parallel.expert import expert_extent

    params = dict(state.model.named_parameters())
    if list(saved) != list(params):
        missing, extra = set(params) - set(saved), set(saved) - set(params)
        raise ValueError(
            f"checkpoint parameters differ from the model's (missing {sorted(missing)}, "
            f"unexpected {sorted(extra)}, or in another order)"
        )
    for name, p in params.items():
        shape = tuple(p.shape)
        if expert_extent(p) > 1:
            shape = (shape[0] * expert_extent(p),) + shape[1:]
        if tuple(saved[name].shape) != shape:
            raise ValueError(f"{name}: checkpoint shape {tuple(saved[name].shape)} != {shape}")


@torch.no_grad()
def _copy_params(state: Any, payload: Dict[str, Any]) -> None:
    saved = payload["params"]
    _check_params(state, saved)
    for name, p in state.model.named_parameters():
        p.copy_(saved[name])


@torch.no_grad()
def _copy_optimizer(opt, osd: Dict[str, Any]) -> None:
    live_groups = opt.param_groups
    if len(osd["param_groups"]) != len(live_groups) or any(
        len(g["params"]) != len(lg["params"]) for g, lg in zip(osd["param_groups"], live_groups)
    ):
        raise ValueError("checkpoint optimizer param groups differ from the live optimizer's")
    live_params = [p for g in live_groups for p in g["params"]]
    saved_state = osd["state"]
    for idx, p in enumerate(live_params):
        values = saved_state.get(idx)
        if values is None:
            opt.state.pop(p, None)
            continue
        live = opt.state[p]
        for key, val in values.items():
            if not isinstance(val, torch.Tensor):
                live[key] = val
                continue
            cur = live.get(key)
            if isinstance(cur, torch.Tensor) and cur.shape == val.shape and cur.dtype == val.dtype:
                cur.copy_(val)
            elif key == "step":  # a scalar counter stays where the optimizer keeps it
                live[key] = val.clone()
            else:
                fresh = torch.empty(val.shape, dtype=val.dtype, device=p.device)
                fresh.copy_(val)
                live[key] = fresh
        for key in set(live) - set(values):
            del live[key]
    for group, saved_group in zip(live_groups, osd["param_groups"]):
        group.update({k: v for k, v in saved_group.items() if k != "params"})


_DENSE_ZERO = {"stage": 0, "bucket_mb": None, "shards": 1}


def restore_zero_compat(
    checkpointer: Checkpointer,
    state_template: Any,
    *,
    live_meta: Optional[Dict[str, Any]] = None,
    step: Optional[int] = None,
) -> Any:
    """Restore a TrainState across ``zero_stage`` / bucket / data-width
    transitions, as JAX's does.

    Under ZeRO-1 the optimizer state is saved as flat bucket vectors
    (:mod:`maggy_tpu_torch.parallel.overlap`), a layout keyed by the bucket
    plan, which changes with ``bucket_mb`` and the ``data`` width. The
    sidecar meta records it (``checkpoint_meta()["zero"]``); when it
    differs from the live trainer's, this restore warns, counts
    ``resilience.ckpt_zero_reshards``, and converts the optimizer state
    (dense to flat, flat to dense, or flat to flat across plans) before it
    is copied in. With matching layouts it is exactly
    :meth:`Checkpointer.restore`. Under a mesh the saved layout is rank
    0's, read from rank 0's checkpoint, and rank 0 converts."""
    import functools

    from maggy_tpu_torch import telemetry

    live_zero = dict((live_meta or {}).get("zero") or _DENSE_ZERO)

    def saved():
        resolved = int(step) if step is not None else checkpointer.latest_step()
        saved_meta = checkpointer.saved_meta(resolved) if resolved is not None else None
        return resolved, dict((saved_meta or {}).get("zero") or _DENSE_ZERO)

    if _collective(state_template):  # rank 0's checkpoint: its answer
        import torch.distributed as dist

        from maggy_tpu_torch.parallel.mesh import from_rank0

        resolved, saved_zero = from_rank0(saved() if dist.get_rank() == 0 else None)
    else:
        resolved, saved_zero = saved()
    if saved_zero == live_zero:
        return checkpointer.restore(state_template, step=step, expect_meta=live_meta)
    telemetry.get().count("resilience.ckpt_zero_reshards")
    warnings.warn(
        f"checkpoint step {resolved} holds a {_zero_desc(saved_zero)} optimizer-state layout; converting to "
        f"the live {_zero_desc(live_zero)} layout during restore",
        stacklevel=2,
    )
    convert = functools.partial(convert_zero_payload, saved=saved_zero, live=live_zero)
    return checkpointer.restore(state_template, step=step, expect_meta=live_meta, convert=convert)


def _zero_plan(params: Dict[str, torch.Tensor], zero: Dict[str, Any]):
    """``(plan, order, leaves)`` of a ZeRO-1 layout over ``params`` (the
    checkpoint's, in ``named_parameters()`` order): its bucket plan, each
    plan leaf's index in that order, and the leaves in plan order; None
    for the dense layout."""
    from maggy_tpu_torch.parallel import overlap

    if int(zero.get("stage") or 0) == 0:
        return None
    names = list(params)
    index = {name: i for i, name in enumerate(names)}
    leaves_in_order = overlap.jax_leaf_order(names)
    leaves = [params[n] for n in leaves_in_order]
    plan = overlap.plan_buckets(leaves, zero.get("bucket_mb"), pad_to=max(1, int(zero.get("shards") or 1)))
    return plan, [index[n] for n in leaves_in_order], leaves


def convert_zero_payload(payload: Dict[str, Any], *, saved: Dict[str, Any], live: Dict[str, Any]) -> Dict[str, Any]:
    """A loaded checkpoint with its optimizer state converted from the
    ``saved`` ZeRO layout to the ``live`` one (each a
    ``checkpoint_meta()["zero"]``): the flat bucket vectors of ZeRO-1 back
    to one state per parameter, then, for a ZeRO-1 live layout, into its
    own plan's buckets (padding rebuilt for its width)."""
    from maggy_tpu_torch.parallel import overlap

    params = payload["params"]
    opt = payload["optimizer"]
    layout = _zero_plan(params, saved)
    if layout is not None:  # flat -> per leaf (plan order) -> per parameter
        plan, order, leaves = layout
        dense = overlap.unflatten_opt_state(opt, plan, leaves)
        opt = {"state": {order[i]: v for i, v in dense["state"].items()},
               "param_groups": [{**dense["param_groups"][0], "params": list(range(len(params)))}]}
    layout = _zero_plan(params, live)
    if layout is not None:  # per parameter -> per leaf (plan order) -> flat
        plan, order, leaves = layout
        per_leaf = {i: opt["state"][p] for i, p in enumerate(order) if p in opt["state"]}
        opt = overlap.flatten_opt_state({"state": per_leaf, "param_groups": opt["param_groups"]}, plan, leaves)
    return {**payload, "optimizer": opt}


def _zero_desc(zero: Dict[str, Any]) -> str:
    if int(zero.get("stage") or 0) == 0:
        return "dense (zero_stage=0)"
    return f"ZeRO-1 (shards={zero.get('shards')}, bucket_mb={zero.get('bucket_mb')})"


def load_finalized_trials(exp_dir: str) -> list:
    """Load every persisted trial.json under a previous experiment directory
    (the driver's persistence format, hpo.py _persist_trial). Goes through the
    Env abstraction."""
    from maggy_tpu_torch.core.env import EnvSing
    from maggy_tpu_torch.trial import Trial

    env = EnvSing.get_instance()
    out = []
    if not env.exists(exp_dir):
        raise FileNotFoundError(f"resume_from directory does not exist: {exp_dir}")
    for name in env.listdir(exp_dir):
        path = os.path.join(exp_dir, name, "trial.json")
        if not env.exists(path):
            continue
        try:
            trial = Trial.from_dict(env.load_json(path))
        except (json.JSONDecodeError, KeyError, ValueError):
            continue
        if trial.status in (Trial.FINALIZED, Trial.ERROR):
            out.append(trial)
    return out
