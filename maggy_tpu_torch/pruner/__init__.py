from maggy_tpu_torch.pruner.abstractpruner import AbstractPruner
from maggy_tpu_torch.pruner.hyperband import Hyperband

__all__ = ["AbstractPruner", "Hyperband"]
