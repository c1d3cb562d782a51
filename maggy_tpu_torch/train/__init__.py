from maggy_tpu_torch.train.data import BatchIterator, synthetic_lm_batches
from maggy_tpu_torch.train.optim import adamw
from maggy_tpu_torch.train.trainer import (
    Trainer,
    TrainState,
    classification_loss_fn,
    lm_loss_fn,
)

__all__ = [
    "BatchIterator",
    "TrainState",
    "Trainer",
    "adamw",
    "classification_loss_fn",
    "lm_loss_fn",
    "synthetic_lm_batches",
]
