from maggy_tpu_torch.models.transformer import Decoder, DecoderConfig, default_attention

__all__ = ["Decoder", "DecoderConfig", "default_attention"]
