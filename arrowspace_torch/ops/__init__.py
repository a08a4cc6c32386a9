"""Search and λτ operators: plain PyTorch code plus the hand-written CUDA
kernels (csrc/) it launches on the card."""
from .search import (  # noqa: F401
    lambda_aware_scores,
    batched_lambda_aware_topk,
    cosine_scores,
)
