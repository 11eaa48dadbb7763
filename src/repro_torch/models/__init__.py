"""The dense decoder-only LM of the slice (global attention, SwiGLU MLP)."""
