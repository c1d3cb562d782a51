"""Decoder ⇄ pipeline adapter: the stage functions of the flagship model.

Counterpart of :mod:`maggy_tpu.train.pipeline_adapter`: the pieces
:func:`maggy_tpu_torch.parallel.pipeline.pipeline_grads_1f1b` needs to train
a :class:`~maggy_tpu_torch.models.Decoder` in stages — the embedding looked
up on stage 0 (``first_fn``), ``n_layers / n_stages`` decoder layers a stage
(``stage_fn``), the final norm and ``lm_head`` inside the last stage's loss
(``head_fn``) — and the maps between the Decoder's parameters and the
stages' (``restack``, ``unstack``, :func:`convert_pipeline_state`).

Layout. Each stage rank holds a :class:`DecoderStage`: its layers, the
embedding on stage 0 only, and the final norm and ``lm_head`` on the last
stage only; every parameter keeps the Decoder's name
(``layers.5.attn.wq.weight``). An :class:`~maggy_tpu_torch.models.moe.MoEDecoder`
is staged the same way: the stage holds ``MoELayer``s under the
MoEDecoder's own names (``layers.1.moe.w_gate``), its stage function
returns ``(y, aux)``, the router terms of the stage's layers
(``stage_has_aux``, as JAX's), and the Trainer places its experts over
``expert`` and their hidden width over ``tensor``
(:func:`~maggy_tpu_torch.parallel.expert.expert_parallelize`). JAX gives every leaf a leading
``[n_stages]`` axis instead, so each device keeps a copy of the embedding
and the head that only one stage reads (ROADMAP, deliberate divergences).
``restack`` and ``unstack`` map a Decoder ``state_dict`` (or anything keyed
by parameter name, such as AdamW's moments) to one dict a stage and back.

Inside a stage the layers run without layer-level remat: the 1F1B clock
already re-runs the stage's forward at its backward tick, so on every stage
but the last the flash forward runs twice a microbatch and the backward
kernels once (JAX nests the layers' remat inside that recompute too).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, List, Mapping, Optional

import torch
from torch import nn

from maggy_tpu_torch.models.moe import MoELayer
from maggy_tpu_torch.models.transformer import Decoder, DecoderLayer, Dense, RMSNorm, _lookup
from maggy_tpu_torch.parallel.expert import is_moe

# gradient-overlap seam: pp-composed configurations get no per-stage
# bucketing (JAX's neither). A zero_stage/bucket_mb request on a pp mesh (or
# any other overlap-ineligible geometry) lands here: one process-wide
# warning, then the dense or pipeline step runs unchanged
_overlap_fallback_warned = False


def warn_overlap_unbucketed(reason: str) -> None:
    """Warn once per process that a requested gradient-overlap
    configuration falls back to the unbucketed path; training proceeds
    unchanged."""
    global _overlap_fallback_warned
    if _overlap_fallback_warned:
        return
    _overlap_fallback_warned = True
    warnings.warn(
        f"gradient overlap disabled: {reason}; training continues on the unbucketed path",
        stacklevel=3,
    )


def _draws(cfg):
    """``(name, shape, std)`` of every draw ``Decoder.reset_parameters``
    (an ``MoEConfig``'s: ``MoEDecoder.reset_parameters``) makes, in its
    order: the embedding, each layer's projections (and router), ``lm_head``,
    then each MoE layer's experts."""
    d, hd = cfg.d_model, cfg.head_dim
    moe = is_moe(cfg)
    out = [("embedding", (cfg.vocab_size, d), 1.0)]
    for i in range(cfg.n_layers):
        shapes = [("attn.wq", (cfg.n_heads * hd, d)), ("attn.wk", (cfg.n_kv_heads * hd, d)),
                  ("attn.wv", (cfg.n_kv_heads * hd, d)), ("attn.wo", (d, cfg.n_heads * hd))]
        shapes += ([("moe.router", (cfg.n_experts, d))] if moe else
                   [("mlp.w_gate", (cfg.d_ff, d)), ("mlp.w_up", (cfg.d_ff, d)), ("mlp.w_down", (d, cfg.d_ff))])
        out += [(f"layers.{i}.{name}.weight", shape, 0.02) for name, shape in shapes]
    out.append(("lm_head.weight", (cfg.vocab_size, d), 0.02))
    if moe:
        e, f = cfg.n_experts, cfg.d_ff
        for i in range(cfg.n_layers):
            out += [(f"layers.{i}.moe.{w}", shape, 0.02)
                    for w, shape in (("w_gate", (e, d, f)), ("w_up", (e, d, f)), ("w_down", (e, f, d)))]
    return out


class DecoderStage(nn.Module):
    """Stage ``stage`` of ``n_stages`` of a ``Decoder(cfg)`` (of an
    ``MoEDecoder(cfg)`` for an ``MoEConfig``): layers ``[stage * L/S,
    (stage + 1) * L/S)`` (a ``ModuleDict`` keyed by their index in the
    Decoder), the embedding on stage 0 and the final norm and ``lm_head``
    on the last. Its weights are empty until :meth:`reset_parameters` or
    ``load_state_dict``."""

    def __init__(self, cfg, stage: int, n_stages: int, device):
        super().__init__()
        device = torch.device(device)
        self.cfg, self.stage, self.n_stages = cfg, stage, n_stages
        per = cfg.n_layers // n_stages
        first = stage * per
        self.embedding = (nn.Parameter(torch.empty((cfg.vocab_size, cfg.d_model), dtype=cfg.param_dtype,
                                                   device=device)) if stage == 0 else None)
        layer_cls = MoELayer if is_moe(cfg) else DecoderLayer
        self.layers = nn.ModuleDict({str(i): layer_cls(cfg, device) for i in range(first, first + per)})
        last = stage == n_stages - 1
        self.final_norm = RMSNorm(cfg, device) if last else None
        self.lm_head = Dense(cfg.d_model, cfg.vocab_size, cfg, device) if last else None

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """This stage's part of ``Decoder.reset_parameters(generator)``: the
        generator runs through every draw of the whole Decoder, in its
        order (:func:`_draws`), and this stage keeps its own, so a stage
        holds exactly the weights the Decoder would from the same
        generator."""
        cfg = self.cfg
        params = dict(self.named_parameters())
        scratch = None

        def draw(name, shape, std):
            nonlocal scratch
            mine = params.get(name)
            if mine is None:
                n = int(torch.Size(shape).numel())
                if scratch is None or scratch.numel() < n:
                    device = next(iter(params.values())).device
                    scratch = torch.empty(n, dtype=cfg.param_dtype, device=device)
                mine = scratch[:n].view(shape)
            mine.normal_(0.0, std, generator=generator)

        for name, shape, std in _draws(cfg):
            draw(name, shape, std)
        for mod in self.modules():
            if isinstance(mod, RMSNorm):
                mod.scale.fill_(1.0)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return _lookup(tokens, self.embedding).to(self.cfg.dtype)

    def forward(self, x, positions, segment_ids=None):
        for layer in self.layers.values():
            x = layer(x, positions, None, segment_ids)
        return x

    def head(self, x: torch.Tensor) -> torch.Tensor:
        logits = self.lm_head(self.final_norm(x))
        if self.cfg.logits_softcap:
            logits = torch.tanh(logits / self.cfg.logits_softcap) * self.cfg.logits_softcap
        return logits.float()


@dataclasses.dataclass(frozen=True)
class DecoderPipelineParts:
    """Everything the Trainer needs to run a Decoder under 1F1B."""

    n_stages: int
    layers_per_stage: int
    first_fn: Callable  # (stage, raw [mb,S] | [mb,S,2|3]) -> x [mb,S,D]
    stage_fn: Callable  # (stage, x, raw) -> x
    head_fn: Callable   # (stage, x) -> logits [mb,S,V] fp32
    restack: Callable   # {name: value} of the Decoder -> [{name: value} of each stage]
    unstack: Callable   # [{name: value} of each stage] -> {name: value} of the Decoder
    make_stage: Callable  # (stage, device) -> DecoderStage, weights empty
    stage_has_aux: bool = False
    # the Decoder parameter names each stage holds, in the Decoder's order
    stage_names: Any = None

    def stage_of(self, name: str) -> int:
        """The stage that holds the Decoder parameter ``name``."""
        for s, names in enumerate(self.stage_names):
            if name in names:
                return s
        raise KeyError(f"no stage holds {name!r}")


def _side_inputs(x, raw):
    """Positions and segment ids from a raw microbatch: ``[mb, S]`` tokens
    alone, or ``[mb, S, 2]`` (tokens, positions) or ``[mb, S, 3]`` (tokens,
    positions, segment ids)."""
    if raw.dim() == 3:
        return raw[..., 1], (raw[..., 2] if raw.shape[-1] >= 3 else None)
    return torch.arange(x.shape[1], device=x.device).expand(x.shape[:2]), None


def decoder_pipeline_parts(model: Any, n_stages: int, tp: int = 1, mesh=None, ep: int = 1) -> DecoderPipelineParts:
    """Build the pipeline parts of a :class:`Decoder` (``model`` itself is
    read for its ``cfg`` only; it may lie on the meta device).

    Raises for anything the pipeline cannot honour, as JAX's does. ``mesh``
    is accepted for JAX's signature: the stage attention is the port's own
    ``auto_attention`` on whatever heads the stage holds (the flash kernels
    on CUDA, ``n_heads / tp`` of them under tensor parallelism), so it needs
    no mesh. An ``MoEDecoder``'s parts have ``stage_has_aux``: the stage
    function returns ``(y, aux)``, the router terms of the stage's layers
    on that microbatch."""
    moe = is_moe(model)
    if not isinstance(model, Decoder):
        raise ValueError(
            "Pipeline parallelism (pp>1) currently supports the Decoder family only, got "
            f"{type(model).__name__}. Drop pp from the ShardingSpec or use parallel.pipeline primitives directly."
        )
    cfg = model.cfg
    if cfg.decode:
        raise ValueError("pp>1 is a training path; decode=True has no pipeline support")
    if cfg.n_layers % n_stages:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by pp={n_stages} stages")
    if cfg.ablated:
        raise ValueError(
            "pp>1 with cfg.ablated is not supported: the stage chunks would silently ignore the LOCO gates. "
            "Ablate without pipeline stages."
        )
    if cfg.tie_embeddings:
        raise ValueError(
            "tie_embeddings=True is not supported with pp>1: the input embedding lives on stage 0 and the "
            "head on the last stage, and each would only receive its own partial gradient — the copies would "
            "silently untie. Use tie_embeddings=False under pp."
        )
    if tp > 1 and (cfg.n_heads % tp or cfg.n_kv_heads % tp):
        raise ValueError(
            f"n_heads={cfg.n_heads} / n_kv_heads={cfg.n_kv_heads} not divisible by tp={tp}: the stage-local "
            "attention shards BOTH head axes over the tensor mesh axis (GQA kv heads included)"
        )
    if ep > 1 and not moe:
        raise ValueError(
            f"ep={ep} under pp>1 needs an MoE model (got {type(model).__name__}): a dense model has no expert "
            "dims, so the expert axis would silently replicate every stage param and waste ep-1 of every ep "
            "devices"
        )
    if ep > 1 and cfg.n_experts % ep:
        raise ValueError(
            f"n_experts={cfg.n_experts} not divisible by ep={ep}: the expert axis would silently replicate "
            "instead of sharding the expert FFNs (pp x ep)"
        )
    from maggy_tpu_torch.parallel.sharding import check_tensor_parallel

    check_tensor_parallel(cfg, tp)
    per = cfg.n_layers // n_stages

    def make_stage(stage: int, device) -> DecoderStage:
        return DecoderStage(cfg, stage, n_stages, device)

    stage_names = tuple(tuple(n for n, _ in make_stage(s, "meta").named_parameters()) for s in range(n_stages))
    order = [n for names in stage_names for n in names]

    def first_fn(stage: DecoderStage, raw):
        return stage.embed(raw[..., 0] if raw.dim() == 3 else raw)

    def stage_fn(stage: DecoderStage, x, raw):
        positions, segment_ids = _side_inputs(x, raw)
        y = stage(x, positions, segment_ids)
        if not moe:
            return y
        from maggy_tpu_torch.train.trainer import collect_aux_losses

        # this stage's router terms on this microbatch (the one collecting rule)
        return y, collect_aux_losses(stage, y.device)

    def head_fn(stage: DecoderStage, x):
        return stage.head(x)

    def restack(params: Mapping[str, Any]) -> List[Dict[str, Any]]:
        """Decoder ``{name: value}`` -> one dict a stage (names missing from
        ``params`` are left out)."""
        return [{n: params[n] for n in names if n in params} for names in stage_names]

    def unstack(stages) -> Dict[str, Any]:
        """One dict a stage -> the Decoder's ``{name: value}``, in its order."""
        merged = {k: v for part in stages for k, v in part.items()}
        return {n: merged[n] for n in order if n in merged}

    return DecoderPipelineParts(
        n_stages=n_stages,
        layers_per_stage=per,
        first_fn=first_fn,
        stage_fn=stage_fn,
        head_fn=head_fn,
        restack=restack,
        unstack=unstack,
        make_stage=make_stage,
        stage_has_aux=moe,
        stage_names=stage_names,
    )


def convert_pipeline_state(state: Dict[str, Any], old_parts: DecoderPipelineParts,
                           new_parts: DecoderPipelineParts) -> Dict[str, Any]:
    """Re-stage a pipeline state across pp degrees: every per-stage list in
    ``state`` — ``"params"`` and ``"optimizer"`` (each stage's AdamW state,
    keyed by parameter name) — goes through ``old_parts.unstack`` then
    ``new_parts.restack``; the rest (``"step"``, the optimizer's
    hyperparameters) passes through. A stage of the result is what
    ``Trainer.adopt_state`` places on that stage's ranks."""
    out = dict(state)
    for key in ("params", "optimizer"):
        if key in state:
            out[key] = new_parts.restack(old_parts.unstack(state[key]))
    return out


@dataclasses.dataclass
class PipelineLayout:
    """What a pipeline :class:`~maggy_tpu_torch.train.trainer.TrainState`
    carries beside its stage (``TrainState.pipeline``): the parts, this
    rank's stage and the mesh, which checkpoints and ``adopt_state`` read."""

    parts: DecoderPipelineParts
    stage: int
    mesh: Any

    @property
    def leader(self) -> bool:
        """Whether this rank speaks for its stage: the first rank of the
        stage on every other axis (the others hold the same parameters, or
        under ``tensor`` the same whole ones once gathered)."""
        from maggy_tpu_torch.parallel.mesh import mesh_shape
        from maggy_tpu_torch.parallel.spec import AXIS_STAGE

        return all(self.mesh.get_local_rank(a) == 0 for a, n in mesh_shape(self.mesh).items()
                   if a != AXIS_STAGE and n > 1)


def stage_state(state) -> Dict[str, Any]:
    """This rank's stage of a pipeline ``TrainState``, whole and on the
    host: ``{"step", "params": {name: tensor}, "optimizer": {name: {moment:
    tensor}}, "hyper": the optimizer's hyperparameters}``, every name the
    Decoder's. Under ``tensor`` the shards are gathered, and an MoE stage's
    experts (and their moments) over ``expert``, so every rank of the stage
    must call it."""
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions,
        get_model_state_dict,
        get_optimizer_state_dict,
    )

    from maggy_tpu_torch.parallel.expert import expert_params, gather_expert_tensor

    full = StateDictOptions(full_state_dict=True)
    params = get_model_state_dict(state.model, options=full)
    optim = get_optimizer_state_dict(state.model, state.optimizer, options=full)
    for name, (_, place) in expert_params(state.model).items():
        params[name] = gather_expert_tensor(params[name], place)
        moments = optim["state"].get(name, {})
        for m, v in moments.items():
            if isinstance(v, torch.Tensor) and v.dim() > 0:
                moments[m] = gather_expert_tensor(v, place)

    def host(v):  # a copy: on the CPU the state dict holds the live tensors themselves
        return v.detach().to("cpu", copy=True) if isinstance(v, torch.Tensor) else v

    return {
        "step": int(state.step),
        "params": {k: host(v) for k, v in params.items()},
        "optimizer": {k: {m: host(v) for m, v in per.items()} for k, per in optim["state"].items()},
        "hyper": {k: v for k, v in optim["param_groups"][0].items() if k != "params"},
    }


def load_stage_state(state, part: Dict[str, Any]) -> None:
    """Copy a :func:`stage_state` of this rank's stage (whole tensors) into
    the live stage, in place: parameters (sharded here under ``tensor``; an
    MoE stage's experts cut to this rank's over ``expert``), AdamW state,
    hyperparameters and the step."""
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions,
        set_model_state_dict,
        set_optimizer_state_dict,
    )

    from maggy_tpu_torch.parallel.expert import expert_params

    full = StateDictOptions(full_state_dict=True)
    names = [n for n, _ in state.model.named_parameters()]
    if sorted(part["params"]) != sorted(names):
        raise ValueError(
            f"stage {state.pipeline.stage}'s parameters differ from the state's: missing "
            f"{sorted(set(names) - set(part['params']))}, unexpected {sorted(set(part['params']) - set(names))}"
        )
    params = dict(part["params"])
    optim = {"state": {n: dict(part["optimizer"][n]) for n in names if n in part["optimizer"]},
             "param_groups": [{**part["hyper"], "params": names}]}
    for name, (_, place) in expert_params(state.model).items():  # this rank's experts of the whole
        n = params[name].shape[0] // place.ep
        mine = slice(place.rank * n, (place.rank + 1) * n)
        params[name] = params[name][mine]
        moments = optim["state"].get(name, {})
        for m, v in moments.items():
            if isinstance(v, torch.Tensor) and v.dim() > 0:
                moments[m] = v[mine]
    set_model_state_dict(state.model, params, options=full)
    set_optimizer_state_dict(state.model, state.optimizer, optim, options=full)
    state.step = int(part["step"])
