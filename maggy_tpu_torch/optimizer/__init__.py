"""Optimizer registry (reference optimization_driver.py:49-57 controller_dict)."""

from maggy_tpu_torch.optimizer.abstractoptimizer import IDLE, AbstractOptimizer
from maggy_tpu_torch.optimizer.asha import Asha
from maggy_tpu_torch.optimizer.gridsearch import GridSearch
from maggy_tpu_torch.optimizer.randomsearch import RandomSearch
from maggy_tpu_torch.optimizer.singlerun import SingleRun

__all__ = [
    "AbstractOptimizer",
    "IDLE",
    "RandomSearch",
    "GridSearch",
    "SingleRun",
    "Asha",
    "get_optimizer",
]


def get_optimizer(name_or_instance, **kwargs) -> AbstractOptimizer:
    """Resolve an optimizer by registry name or pass through an instance."""
    if isinstance(name_or_instance, AbstractOptimizer):
        return name_or_instance
    if name_or_instance is None:
        return SingleRun(**kwargs)
    name = str(name_or_instance).lower()
    if name in ("randomsearch", "random"):
        return RandomSearch(**kwargs)
    if name in ("gridsearch", "grid"):
        return GridSearch(**kwargs)
    if name in ("none", "singlerun"):
        return SingleRun(**kwargs)
    if name == "asha":
        return Asha(**kwargs)
    if name in ("tpe", "gp"):
        try:
            if name == "tpe":
                from maggy_tpu_torch.optimizer.bayes.tpe import TPE as cls
            else:
                from maggy_tpu_torch.optimizer.bayes.gp import GP as cls
        except ImportError as e:
            raise NotImplementedError(
                f"The {name!r} optimizer requires the bayes module: {e}"
            ) from e
        return cls(**kwargs)
    raise ValueError(
        f"Unknown optimizer {name_or_instance!r}; expected one of "
        "randomsearch, gridsearch, asha, tpe, gp, none or an AbstractOptimizer."
    )


def get_earlystop(name_or_instance):
    from maggy_tpu_torch.earlystop import AbstractEarlyStop, MedianStoppingRule, NoStoppingRule

    if isinstance(name_or_instance, type) and issubclass(name_or_instance, AbstractEarlyStop):
        return name_or_instance
    if isinstance(name_or_instance, AbstractEarlyStop):
        return name_or_instance
    name = str(name_or_instance).lower()
    if name == "median":
        return MedianStoppingRule
    if name in ("none", "nostop"):
        return NoStoppingRule
    raise ValueError(f"Unknown early-stop policy {name_or_instance!r}")
