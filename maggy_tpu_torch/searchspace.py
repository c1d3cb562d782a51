"""Hyperparameter search space.

Capability parity with the reference ``maggy/searchspace.py`` (searchspace.py:23-479):
four parameter types (DOUBLE/INTEGER/DISCRETE/CATEGORICAL), keyword construction,
``add`` validation, attribute access, random sampling, dict/list conversion, and a
bijective transform into the unit hypercube used by the model-based optimizers
(GP/TPE surrogates operate on the transformed space).

The implementation here is new: the unit-cube transform is vectorized over numpy and
INTEGER/DISCRETE/CATEGORICAL use half-open bucket encodings so that
``inverse_transform(transform(x)) == x`` exactly for every representable value.
"""

from __future__ import annotations

import json
import random
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np



class Searchspace:
    """A set of named hyperparameters, each with a type and a feasible region.

    Construct from keyword arguments, where each value is a ``(type, region)``
    tuple — same shape as the reference API (searchspace.py:23-66)::

        sp = Searchspace(kernel=("INTEGER", [2, 8]), lr=("DOUBLE", [1e-5, 1e-1]))
        sp.add("activation", ("CATEGORICAL", ["relu", "gelu", "silu"]))

    DOUBLE and INTEGER take two-element ``[lower, upper]`` bounds (inclusive);
    DISCRETE takes an ordered list of numeric values; CATEGORICAL a list of
    arbitrary (JSON-serializable) values.
    """

    DOUBLE = "DOUBLE"
    INTEGER = "INTEGER"
    DISCRETE = "DISCRETE"
    CATEGORICAL = "CATEGORICAL"

    _TYPES = (DOUBLE, INTEGER, DISCRETE, CATEGORICAL)

    def __init__(self, **kwargs: Any):
        self._hparam_types: Dict[str, str] = {}
        self._hparam_values: Dict[str, list] = {}
        self._names: List[str] = []
        for name, value in kwargs.items():
            self.add(name, value)

    # ------------------------------------------------------------------ basic API

    def add(self, name: str, value: Any) -> None:
        """Add a hyperparameter; validates name, type and feasible region
        (reference searchspace.py:71-150)."""
        if not isinstance(name, str) or not name:
            raise ValueError(f"Hyperparameter name must be a non-empty str: {name!r}")
        if name.startswith("_") or hasattr(type(self), name):
            # Covers every class attribute/method, so dot access can never shadow API.
            raise ValueError(f"Hyperparameter name is reserved: {name}")
        if name in self._hparam_types:
            raise ValueError(f"Hyperparameter already exists: {name}")

        if not isinstance(value, (tuple, list)) or len(value) != 2:
            raise ValueError(
                "Hyperparameter value has to be of length two and format "
                f"(type, region): {name}, {value!r}"
            )

        param_type = str(value[0]).upper()
        region = value[1]
        if param_type not in self._TYPES:
            raise ValueError(
                f"Hyperparameter type has to be one of {self._TYPES}: {name}, {value[0]!r}"
            )
        if not isinstance(region, (tuple, list)) or len(region) == 0:
            raise ValueError(
                f"Hyperparameter feasible region cannot be empty: {name}, {region!r}"
            )
        region = list(region)

        if param_type in (self.DOUBLE, self.INTEGER):
            if len(region) != 2:
                raise ValueError(
                    "For DOUBLE or INTEGER parameters the region must be "
                    f"[lower, upper]: {name}, {region!r}"
                )
            lo, hi = region
            if param_type == self.DOUBLE:
                if not all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in region):
                    raise ValueError(
                        f"DOUBLE bounds must be numeric: {name}, {region!r}"
                    )
                lo, hi = float(lo), float(hi)
            else:
                if not all(isinstance(v, int) and not isinstance(v, bool) for v in region):
                    raise ValueError(
                        f"INTEGER bounds must be integers: {name}, {region!r}"
                    )
            if lo >= hi:
                raise ValueError(
                    f"Lower bound must be strictly less than upper bound: {name}, {region!r}"
                )
            region = [lo, hi]
        elif param_type == self.DISCRETE:
            if not all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in region):
                raise ValueError(
                    f"DISCRETE values must be numeric: {name}, {region!r}"
                )
            if len(set(region)) != len(region):
                raise ValueError(f"DISCRETE values must be unique: {name}, {region!r}")
            region = sorted(region)
        else:  # CATEGORICAL
            if len(set(map(repr, region))) != len(region):
                raise ValueError(f"CATEGORICAL values must be unique: {name}, {region!r}")

        self._hparam_types[name] = param_type
        self._hparam_values[name] = region
        self._names.append(name)
        # Dot access, same convenience as the reference (searchspace.py:55-57).
        setattr(self, name, region)

    def get(self, name: str, default: Any = None) -> Any:
        return self._hparam_values.get(name, default)

    def get_type(self, name: str) -> str:
        return self._hparam_types[name]

    def names(self) -> Dict[str, str]:
        """Return ``{name: type}`` for all hyperparameters."""
        return dict(self._hparam_types)

    def keys(self) -> List[str]:
        return list(self._names)

    def values(self) -> List[list]:
        return [self._hparam_values[n] for n in self._names]

    def items(self) -> Iterator[Dict[str, Any]]:
        """Iterate dicts of ``{name, type, values}`` (reference searchspace.py iteration)."""
        for n in self._names:
            yield {"name": n, "type": self._hparam_types[n], "values": self._hparam_values[n]}

    def __iter__(self):
        return self.items()

    def __len__(self) -> int:
        return len(self._names)

    def __contains__(self, name: str) -> bool:
        return name in self._hparam_types

    def to_dict(self) -> Dict[str, Tuple[str, list]]:
        """Round-trippable dict: ``Searchspace(**sp.to_dict())`` reproduces ``sp``."""
        return {n: (self._hparam_types[n], self._hparam_values[n]) for n in self._names}

    def json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, payload: str) -> "Searchspace":
        return cls(**{k: tuple(v) for k, v in json.loads(payload).items()})

    def __repr__(self) -> str:
        inner = ", ".join(
            f"{n}=({self._hparam_types[n]}, {self._hparam_values[n]})" for n in self._names
        )
        return f"Searchspace({inner})"

    # ------------------------------------------------------------------ sampling

    def sample(self, rng: random.Random = None) -> Dict[str, Any]:
        """Draw one uniform random configuration (reference searchspace.py:180-208)."""
        rng = rng or random
        out = {}
        for n in self._names:
            t = self._hparam_types[n]
            v = self._hparam_values[n]
            if t == self.DOUBLE:
                out[n] = rng.uniform(v[0], v[1])
            elif t == self.INTEGER:
                out[n] = rng.randint(v[0], v[1])
            else:
                out[n] = v[int(rng.random() * len(v)) % len(v)]
        return out

    def get_random_parameter_values(self, num: int, seed: int = None) -> List[Dict[str, Any]]:
        """Draw ``num`` random configurations."""
        rng = random.Random(seed) if seed is not None else random
        return [self.sample(rng) for _ in range(num)]

    # ------------------------------------------------- model-space transform

    # The optimizer-facing encoding maps every hyperparameter into [0, 1):
    #   DOUBLE      x -> (x - lo) / (hi - lo)
    #   INTEGER     x -> (x - lo + 0.5) / (hi - lo + 1)   (bucket midpoints)
    #   DISCRETE    value at sorted index i -> (i + 0.5) / k
    #   CATEGORICAL value at index i       -> (i + 0.5) / k
    # Inverse maps unit values back by bucketing, so round-trips are exact and any
    # point in the cube decodes to a valid configuration (reference
    # searchspace.py:266-353 provides the same capability via min-max scaling).

    def transform(self, params: Dict[str, Any]) -> np.ndarray:
        """Encode a configuration dict as a vector in the unit hypercube."""
        vec = np.empty(len(self._names), dtype=np.float64)
        for i, n in enumerate(self._names):
            t = self._hparam_types[n]
            v = self._hparam_values[n]
            x = params[n]
            if t == self.DOUBLE:
                vec[i] = (float(x) - v[0]) / (v[1] - v[0])
            elif t == self.INTEGER:
                vec[i] = (int(x) - v[0] + 0.5) / (v[1] - v[0] + 1)
            elif t == self.DISCRETE:
                vec[i] = (v.index(x) + 0.5) / len(v)
            else:
                vec[i] = (v.index(x) + 0.5) / len(v)
        return np.clip(vec, 0.0, 1.0)

    def inverse_transform(self, vec: np.ndarray) -> Dict[str, Any]:
        """Decode a unit-cube vector into a valid configuration dict."""
        vec = np.asarray(vec, dtype=np.float64)
        if vec.shape != (len(self._names),):
            raise ValueError(
                f"Expected vector of shape ({len(self._names)},), got {vec.shape}"
            )
        out = {}
        for i, n in enumerate(self._names):
            t = self._hparam_types[n]
            v = self._hparam_values[n]
            u = min(max(float(vec[i]), 0.0), 1.0)
            if t == self.DOUBLE:
                out[n] = v[0] + u * (v[1] - v[0])
            elif t == self.INTEGER:
                k = v[1] - v[0] + 1
                out[n] = v[0] + min(int(u * k), k - 1)
            else:
                k = len(v)
                out[n] = v[min(int(u * k), k - 1)]
        return out

    def transform_many(self, param_dicts: List[Dict[str, Any]]) -> np.ndarray:
        """Stack multiple configurations into an ``(n, d)`` design matrix."""
        if not param_dicts:
            return np.empty((0, len(self._names)), dtype=np.float64)
        return np.stack([self.transform(p) for p in param_dicts])

    # ------------------------------------------------- dict <-> list converters

    def dict_to_list(self, params: Dict[str, Any]) -> List[Any]:
        """Order parameter values by searchspace insertion order
        (reference searchspace.py:445-479)."""
        return [params[n] for n in self._names]

    def list_to_dict(self, values: List[Any]) -> Dict[str, Any]:
        if len(values) != len(self._names):
            raise ValueError(
                f"Expected {len(self._names)} values, got {len(values)}"
            )
        return dict(zip(self._names, values))

    def contains(self, params: Dict[str, Any]) -> bool:
        """Check that ``params`` names exactly this space and every value is feasible."""
        if set(params) != set(self._names):
            return False
        for n in self._names:
            t = self._hparam_types[n]
            v = self._hparam_values[n]
            x = params[n]
            if isinstance(x, bool) and t in (self.DOUBLE, self.INTEGER):
                return False
            if t == self.DOUBLE:
                if not isinstance(x, (int, float)) or not v[0] <= x <= v[1]:
                    return False
            elif t == self.INTEGER:
                if not isinstance(x, int) or not v[0] <= x <= v[1]:
                    return False
            elif x not in v:
                return False
        return True
