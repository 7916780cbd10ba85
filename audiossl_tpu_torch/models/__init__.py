from audiossl_tpu_torch.models.atst import (
    AudioTransformer,
    frame_ast_base,
    frame_ast_small,
    frame_ast_tiny,
)
