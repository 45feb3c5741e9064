"""Generation engines of the port (port of `time_r1_tpu/sampler/`)."""

from .continuous import ContinuousEngine
from .engine import Engine, Request
from .paged import PagedEngine
from .params import SamplingParams
from .text_engine import TextEngine

__all__ = ["ContinuousEngine", "Engine", "PagedEngine", "Request", "SamplingParams", "TextEngine"]
