"""The plain PyTorch reference the benchmark's correctness check computes."""
