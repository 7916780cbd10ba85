from audiossl_tpu_torch.methods.dual.method import (DualConfig, DualMethod,
                                                    DualModel)

__all__ = ["DualConfig", "DualMethod", "DualModel"]
