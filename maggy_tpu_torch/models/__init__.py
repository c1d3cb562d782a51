from maggy_tpu_torch.models.bert import Bert, BertConfig
from maggy_tpu_torch.models.mlp import MLP
from maggy_tpu_torch.models.transformer import Decoder, DecoderConfig, default_attention

__all__ = ["Bert", "BertConfig", "MLP", "Decoder", "DecoderConfig", "default_attention"]


def __getattr__(name):
    # the MoE family loads on first use, as the JAX package's does
    import importlib

    lazy = {"MoEDecoder": "maggy_tpu_torch.models.moe", "MoEConfig": "maggy_tpu_torch.models.moe"}
    if name in lazy:
        return getattr(importlib.import_module(lazy[name]), name)
    raise AttributeError(f"module 'maggy_tpu_torch.models' has no attribute {name!r}")
