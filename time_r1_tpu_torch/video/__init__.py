"""Host video input of the port (port of the JAX package's `video/`): the
native FFmpeg decoder, the bicubic resize and `fetch_video`."""

from .decoder import VideoReader
from .pipeline import fetch_video, video_loader

__all__ = ["VideoReader", "fetch_video", "video_loader"]
