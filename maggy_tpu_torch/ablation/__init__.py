from maggy_tpu_torch.ablation.ablationstudy import AblationStudy, Features, ModelSpec

__all__ = ["AblationStudy", "Features", "ModelSpec"]
