"""Host utilities: the optional TensorBoard sink."""
