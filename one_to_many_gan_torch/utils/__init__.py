"""Host utilities: the optional TensorBoard sink, and profiling (a
``torch.profiler`` trace of a block, a step timer)."""
