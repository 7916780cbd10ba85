from audiossl_tpu_torch.methods.mae.method import MAEConfig, MAEMethod, MAEModel

__all__ = ["MAEConfig", "MAEMethod", "MAEModel"]
