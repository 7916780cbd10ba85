from audiossl_tpu_torch.models.atst import (
    AudioTransformer,
    ast_base,
    ast_large,
    ast_small,
    ast_tiny,
    frame_ast_base,
    frame_ast_large,
    frame_ast_small,
    frame_ast_tiny,
)
