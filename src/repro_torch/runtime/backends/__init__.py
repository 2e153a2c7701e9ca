"""Execution backends of the port (``torch_engine.TorchBackend``)."""
