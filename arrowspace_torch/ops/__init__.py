"""Search and λτ operators: plain PyTorch code plus the hand-written CUDA
kernels (csrc/) it launches on the card."""
