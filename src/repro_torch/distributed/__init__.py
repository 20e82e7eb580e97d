from .compression import (  # noqa: F401
    int8_compress_decompress,
    make_compressed_grad_transform,
    topk_compress_decompress,
)
