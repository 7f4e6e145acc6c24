"""The plain reference: fp32 PyTorch, with TF32 off, importing nothing of
the port."""
