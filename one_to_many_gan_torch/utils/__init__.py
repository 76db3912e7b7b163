"""Host utilities: the optional TensorBoard sink, and profiling (a
``torch.profiler`` trace of a block, the program's spans, the device's
busy time in a trace)."""
