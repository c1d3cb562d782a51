"""Attention ops: the plain online-softmax substrate and the flash kernels.

Importing this package loads no CUDA library; the kernels build at first use.
"""

from maggy_tpu_torch.ops.attention import NEG_INF, blockwise_attention, repeat_kv
from maggy_tpu_torch.ops.flash import flash_attention

__all__ = ["NEG_INF", "blockwise_attention", "flash_attention", "repeat_kv"]
