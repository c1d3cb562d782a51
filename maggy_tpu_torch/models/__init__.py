from maggy_tpu_torch.models.mlp import MLP
from maggy_tpu_torch.models.transformer import Decoder, DecoderConfig, default_attention

__all__ = ["MLP", "Decoder", "DecoderConfig", "default_attention"]
