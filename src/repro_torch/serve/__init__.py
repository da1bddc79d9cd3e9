from repro_torch.serve.engine import Request, Result, ServeEngine
from repro_torch.serve.sampler import greedy_sample, temperature_sample

__all__ = ["Request", "Result", "ServeEngine", "greedy_sample",
           "temperature_sample"]
