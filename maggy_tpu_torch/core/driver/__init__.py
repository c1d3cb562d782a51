from maggy_tpu_torch.core.driver.base import Driver
from maggy_tpu_torch.core.driver.hpo import BaseDriver, HyperparameterOptDriver

__all__ = ["Driver", "HyperparameterOptDriver", "BaseDriver"]
