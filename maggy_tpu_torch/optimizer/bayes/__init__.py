from maggy_tpu_torch.optimizer.bayes.base import BaseAsyncBO
from maggy_tpu_torch.optimizer.bayes.gp import GP
from maggy_tpu_torch.optimizer.bayes.tpe import TPE

__all__ = ["BaseAsyncBO", "GP", "TPE"]
