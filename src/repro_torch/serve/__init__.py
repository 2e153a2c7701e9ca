"""Serving layer of the port: engine, driver, sampler."""
from repro_torch.serve.driver import DriverCfg, ServeDriver
from repro_torch.serve.engine import (RealRadixCache, ServingEngine,
                                      SpecDecodeCfg)
from repro_torch.serve.sampler import accept_length, greedy, temperature

__all__ = ["DriverCfg", "ServeDriver", "RealRadixCache", "ServingEngine",
           "SpecDecodeCfg", "accept_length", "greedy", "temperature"]
