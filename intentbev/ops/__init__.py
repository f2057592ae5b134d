from .attention import (
    attention_implementation,
    dot_product_attention,
    padded_seq_len,
    reference_attention,
)

__all__ = [
    "attention_implementation",
    "dot_product_attention",
    "padded_seq_len",
    "reference_attention",
]
