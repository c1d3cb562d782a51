from maggy_tpu_torch.train.checkpoint import Checkpointer, restore_zero_compat
from maggy_tpu_torch.train.data import BatchIterator, batch_iterator, host_shard, synthetic_lm_batches
from maggy_tpu_torch.train.native_loader import NativeBatchLoader
from maggy_tpu_torch.train.optim import adamw
from maggy_tpu_torch.train.prefetch import DevicePrefetcher, skip_batches
from maggy_tpu_torch.train.sharded_dataset import (
    ParquetShardedDataset,
    ShardedDataset,
    ShardedStreamLoader,
    write_parquet,
    write_sharded,
)
from maggy_tpu_torch.train.trainer import (
    TrainContext,
    Trainer,
    TrainState,
    classification_loss_fn,
    collect_aux_losses,
    lm_loss_fn,
    shard_sequence,
)

__all__ = [
    "BatchIterator",
    "Checkpointer",
    "DevicePrefetcher",
    "NativeBatchLoader",
    "ParquetShardedDataset",
    "ShardedDataset",
    "ShardedStreamLoader",
    "TrainContext",
    "TrainState",
    "Trainer",
    "adamw",
    "batch_iterator",
    "classification_loss_fn",
    "collect_aux_losses",
    "host_shard",
    "lm_loss_fn",
    "restore_zero_compat",
    "shard_sequence",
    "skip_batches",
    "synthetic_lm_batches",
    "write_parquet",
    "write_sharded",
]
