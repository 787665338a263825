"""Device ops: precision policy, conv/linear, plain recurrences, mel
front-ends, and the hand-written CUDA kernels' wrappers."""
