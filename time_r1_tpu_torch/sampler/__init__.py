"""Generation engine of the port (port of `time_r1_tpu/sampler/`)."""

from .engine import Engine, Request
from .params import SamplingParams

__all__ = ["Engine", "Request", "SamplingParams"]
