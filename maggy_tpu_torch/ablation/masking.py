"""Factory-free model ablation: the port's counterpart of
:mod:`maggy_tpu.ablation.masking`.

The reference ablates layers of *any* user Keras model by JSON surgery —
``model_from_json`` after deleting named layers (reference loco.py:82-136) —
with zero user plumbing. Here, as in the JAX package, :func:`auto_ablate`
has three tiers, which the ablation driver applies when the study has no
model factory:

1. the model's config has a ``without()`` method (``DecoderConfig``):
   rebuild from ``cfg.without(components)`` — forward-pass gating, unchanged
   parameter shapes;
2. the config is a dataclass with an ``ablated`` field (``BertConfig``):
   rebuild with the component names merged in — the model drops those
   submodules itself;
3. any other ``nn.Module``: :class:`ParamMaskedModel` over a copy of it
   zeros the parameters whose dotted name matches a component — a residual
   block with a zeroed output projection reduces to the identity — and
   keeps them and their gradients at zero through training.

A torch module holds tensors where a flax module is a description, so every
tier returns a new module: the base is never trained, and a later trial
derives its variant from the same untrained base. A rebuild calls the
module's constructor with the new config, the base's device (a ``"meta"``
base gives a meta variant, which costs no memory) and every other
constructor argument the base keeps as an attribute of the same name, the
counterpart of flax's ``Module.clone``; it copies no weights.
"""

from __future__ import annotations

import copy
import dataclasses
import inspect
from typing import Any, FrozenSet, Iterable, Optional, Tuple

import torch
from torch import nn


class ParamMaskedModel(nn.Module):
    """Generic factory-free fallback: runs ``base`` with every matching
    parameter at zero.

    A component name matches a parameter whose dotted name contains it as a
    contiguous run of segments — ``"mlp"`` masks every ``....mlp....``
    parameter, ``"encoder.layer_0"`` only that nested one. Raises at
    construction if a name matches nothing (a typo must not silently train
    the full model).

    The matched parameters are zeroed when the wrapper is built and again
    before every forward (a ``reset_parameters`` in between, as
    ``Trainer.make_state`` does, refills them); the forward sees them as
    ``p * 0``, so their gradients are exactly zero, and an optimizer such as
    AdamW (zero gradient, zero weight) leaves them at zero. Attributes the
    wrapper lacks are read from ``base``."""

    def __init__(self, base: nn.Module, ablated: Iterable[str]):
        super().__init__()
        self.base = base
        self.ablated: FrozenSet[str] = frozenset(ablated)
        self._patterns: Tuple[Tuple[str, ...], ...] = tuple(
            tuple(c.split(".")) for c in sorted(self.ablated)
        )
        hit, names = set(), []
        for name, _ in base.named_parameters():
            pat = self._matched_pattern(tuple(name.split(".")))
            if pat is not None:
                hit.add(pat)
                names.append(name)
        missing = [".".join(p) for p in self._patterns if p not in hit]
        if missing:
            raise ValueError(
                f"Ablated component(s) {missing} match no parameter subtree; "
                "check the names against the model's named_parameters()."
            )
        self.masked: Tuple[str, ...] = tuple(names)
        self.zero_masked()

    def _matched_pattern(self, path_names: Tuple[str, ...]):
        """The first ablated pattern occurring as a contiguous segment
        sequence in ``path_names``, or None."""
        for pat in self._patterns:
            k = len(pat)
            if any(
                tuple(path_names[i : i + k]) == pat
                for i in range(len(path_names) - k + 1)
            ):
                return pat
        return None

    @torch.no_grad()
    def zero_masked(self) -> None:
        params = dict(self.base.named_parameters())
        for name in self.masked:
            params[name].zero_()

    def forward(self, *args, **kwargs):
        self.zero_masked()
        params = dict(self.base.named_parameters())
        zeros = {name: params[name] * 0 for name in self.masked}
        return torch.func.functional_call(self.base, zeros, args, kwargs)

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            base = self.__dict__["_modules"].get("base")
            if base is None:
                raise
            return getattr(base, name)

    def extra_repr(self) -> str:
        return f"ablated={sorted(self.ablated)}"


def _device_of(model: nn.Module) -> Optional[torch.device]:
    for t in model.parameters():
        return t.device
    for t in model.buffers():
        return t.device
    return None


def rebuild(model: nn.Module, cfg: Any = None) -> nn.Module:
    """A new ``type(model)`` built from ``cfg`` (default: the model's own),
    on the model's device, with every other constructor argument the model
    keeps as an attribute of the same name. No weights are copied: a base on
    a real device gets a fresh initialisation there."""
    cfg = model.cfg if cfg is None else cfg
    sig = inspect.signature(type(model).__init__)
    kwargs = {}
    for name, p in list(sig.parameters.items())[1:]:
        if name == "cfg" or p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
            continue
        if name == "device":
            kwargs[name] = _device_of(model)
        elif name in model.__dict__:
            kwargs[name] = model.__dict__[name]
    if "cfg" in sig.parameters:
        return type(model)(cfg=cfg, **kwargs)
    return type(model)(cfg, **kwargs)


def _config_driven(cfg: Any) -> bool:
    return cfg is not None and (
        hasattr(cfg, "without")
        or (dataclasses.is_dataclass(cfg) and any(f.name == "ablated" for f in dataclasses.fields(cfg)))
    )


def fresh(model: Any) -> Any:
    """What a trial that ablates no component gets: a rebuild of a
    config-driven module (tiers 1-2), a copy of any other module (a meta
    base copies for free), and anything that is not a module as it is."""
    if not isinstance(model, nn.Module):
        return model
    if _config_driven(getattr(model, "cfg", None)):
        return rebuild(model)
    return copy.deepcopy(model)


def auto_ablate(model: nn.Module, ablated: FrozenSet[str]) -> nn.Module:
    """Build the ablated variant of ``model`` with zero user plumbing."""
    cfg = getattr(model, "cfg", None)
    if cfg is not None and hasattr(cfg, "without"):
        return rebuild(model, cfg.without(ablated))
    if _config_driven(cfg):
        merged = frozenset(getattr(cfg, "ablated", frozenset())) | frozenset(ablated)
        return rebuild(model, dataclasses.replace(cfg, ablated=merged))
    return ParamMaskedModel(copy.deepcopy(model), ablated)
