"""Declarative ablation-study specification: the port's copy of
:mod:`maggy_tpu.ablation.ablationstudy`.

Capability parity with the reference ``maggy/ablation/ablationstudy.py:18-408``:
``study.features.include(...)`` marks dataset columns for leave-one-out removal,
``study.model.layers.include(...)`` / ``include_groups(...)`` marks model
components (single names, or groups ablated together), and custom model
generators cover anything declarative names cannot.

Model surgery is **factory-free by default** (matching the reference's
zero-plumbing Keras-JSON surgery, loco.py:82-136): when the study has no
factory the driver derives each variant from the config model via
:func:`maggy_tpu_torch.ablation.masking.auto_ablate` — ``cfg.without(components)``
for config-driven families (Decoder), an ``ablated`` config field rebuild
(Bert), or generic parameter zero-masking for any other ``nn.Module``. A
**model factory** ``fn(ablated: frozenset[str]) -> nn.Module`` remains the
escape hatch for fully custom surgery.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, FrozenSet, Iterable, List, Optional


class Features:
    """Dataset columns to ablate one at a time (reference ablationstudy.py
    features API)."""

    def __init__(self):
        self.included: List[str] = []

    def include(self, *names: str) -> None:
        for name in _flatten(names):
            if not isinstance(name, str):
                raise ValueError(f"Feature names must be str, got {name!r}")
            if name not in self.included:
                self.included.append(name)

    def exclude(self, *names: str) -> None:
        for name in _flatten(names):
            if name in self.included:
                self.included.remove(name)

    def list_all(self) -> List[str]:
        return list(self.included)


class _Layers:
    """Model components to ablate: single names and groups (ablated together),
    mirroring ``model.layers.include`` / ``include_groups`` (reference
    ablationstudy.py:306-347)."""

    def __init__(self):
        self.included: List[str] = []
        self._groups: List[FrozenSet[str]] = []
        self._prefixes: List[str] = []

    def include(self, *names: str) -> None:
        for name in _flatten(names):
            if not isinstance(name, str):
                raise ValueError(f"Component names must be str, got {name!r}")
            if name not in self.included:
                self.included.append(name)

    def exclude(self, *names: str) -> None:
        for name in _flatten(names):
            if name in self.included:
                self.included.remove(name)

    def include_groups(self, *groups: Iterable[str], prefix: Optional[str] = None) -> None:
        if prefix is not None:
            if groups:
                raise ValueError("Pass either explicit groups or a prefix, not both")
            self._prefixes.append(prefix)
            return
        for group in groups:
            fs = frozenset(group)
            if not fs:
                raise ValueError("Cannot include an empty component group")
            if fs not in self._groups:
                self._groups.append(fs)

    @property
    def included_groups(self) -> List[FrozenSet[str]]:
        """Explicit groups plus prefix groups resolved against the included
        components (reference prefix groups resolve against Keras layer names,
        ablationstudy.py:306-347)."""
        out = list(self._groups)
        for prefix in self._prefixes:
            group = frozenset(c for c in self.included if c.startswith(prefix))
            if not group:
                raise ValueError(
                    f"Prefix group {prefix!r} matches no included components "
                    f"{self.included}; call layers.include(...) first."
                )
            if group not in out:
                out.append(group)
        return out

    def list_all(self) -> List[Any]:
        return list(self.included) + list(self.included_groups)


class ModelSpec:
    def __init__(self):
        self.layers = _Layers()
        self._factory: Optional[Callable[[FrozenSet[str]], Any]] = None
        self.custom_generators: Dict[str, Callable[[], Any]] = {}

    def set_factory(self, fn: Callable[[FrozenSet[str]], Any]) -> None:
        """``fn(ablated_components) -> model`` — called with frozenset() for the
        baseline trial and with each ablation target otherwise."""
        self._factory = fn

    @property
    def factory(self) -> Optional[Callable[[FrozenSet[str]], Any]]:
        return self._factory

    def add_custom_generator(self, name: str, fn: Callable[[], Any]) -> None:
        """A fully custom model variant, one trial per generator (reference
        ablationstudy.py:240-250)."""
        self.custom_generators[name] = fn


class AblationStudy:
    """Spec consumed by the LOCO ablator.

    Example::

        study = AblationStudy()
        study.features.include("age", "income")
        study.model.layers.include("mlp", "attn")
        study.model.set_factory(lambda ablated: Decoder(cfg.without(ablated)))
    """

    def __init__(
        self,
        dataset_generator: Optional[Callable] = None,
        label_name: Optional[str] = None,
    ):
        """:param dataset_generator: optional ``fn(dataset, ablated_feature) ->
            dataset``; the default handles dict-of-arrays datasets by dropping
            the feature key (the TPU-native stand-in for the reference's
            feature-store TFRecord schema editing, loco.py:41-80).
        :param label_name: column never ablated.
        """
        self.features = Features()
        self.model = ModelSpec()
        self.dataset_generator = dataset_generator
        self.label_name = label_name

    def to_dict(self) -> Dict[str, Any]:
        return {
            "features": self.features.list_all(),
            "components": self.model.layers.included,
            "component_groups": [sorted(g) for g in self.model.layers.included_groups],
            "custom_generators": sorted(self.model.custom_generators),
            "label_name": self.label_name,
        }


def _flatten(names):
    for n in names:
        if isinstance(n, (list, tuple, set, frozenset)):
            yield from _flatten(n)
        else:
            yield n


def default_dataset_generator(dataset: Any, ablated_feature: Optional[str]) -> Any:
    """Drop one feature from the dataset, schema-style (the reference edits
    the feature-store TFRecord schema automatically, loco.py:41-80):

    * dict-of-arrays — the key is dropped;
    * ``ShardedDataset`` / ``ParquetShardedDataset`` — rebuilt with a
      column list excluding the feature (no file rewrites: the loader just
      stops reading that field/column);
    * anything else — pass ``AblationStudy(dataset_generator=...)``.

    The Parquet class imports ``pyarrow`` only when one is built.
    """
    if ablated_feature is None or dataset is None:
        return dataset
    if isinstance(dataset, dict):
        if ablated_feature not in dataset:
            raise KeyError(
                f"Ablated feature {ablated_feature!r} not in dataset keys "
                f"{sorted(dataset)}"
            )
        return {k: v for k, v in dataset.items() if k != ablated_feature}
    from maggy_tpu_torch.train.sharded_dataset import (
        ParquetShardedDataset,
        ShardedDataset,
    )

    if isinstance(dataset, (ParquetShardedDataset, ShardedDataset)):
        fields = dataset.fields
        if ablated_feature not in fields:
            raise KeyError(
                f"Ablated feature {ablated_feature!r} not in dataset fields "
                f"{sorted(fields)}"
            )
        keep = [f for f in fields if f != ablated_feature]
        if not keep:
            raise ValueError("Cannot ablate the only field of a dataset")
        if isinstance(dataset, ParquetShardedDataset):
            return ParquetShardedDataset(dataset.path, columns=keep)
        return ShardedDataset(dataset.data_dir, columns=keep)
    raise TypeError(
        "Default dataset generator handles dict and (Parquet)ShardedDataset "
        "datasets; pass AblationStudy(dataset_generator=...) for custom types."
    )
