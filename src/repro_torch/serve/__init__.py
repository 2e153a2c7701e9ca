"""Serving layer of the port: engine, driver, sampler."""
from repro_torch.serve.driver import DriverCfg, ServeDriver
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.sampler import greedy

__all__ = ["DriverCfg", "ServeDriver", "ServingEngine", "greedy"]
