from maggy_tpu_torch.train.data import BatchIterator, synthetic_lm_batches
from maggy_tpu_torch.train.optim import adamw
from maggy_tpu_torch.train.trainer import (
    TrainContext,
    Trainer,
    TrainState,
    classification_loss_fn,
    lm_loss_fn,
    shard_sequence,
)

__all__ = [
    "BatchIterator",
    "TrainContext",
    "TrainState",
    "Trainer",
    "adamw",
    "classification_loss_fn",
    "lm_loss_fn",
    "shard_sequence",
    "synthetic_lm_batches",
]
