"""Layers of the port as ``nn.Module``s."""
