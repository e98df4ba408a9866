"""The serving layer: admission, micro-batching, the continuous lane pool
and latency histograms around one ``RangeSearchEngine``."""
from .latency import LatencyHistogram
from .scheduler import LaneScheduler
from .server import REQUEST_OPS, RangeServer, Request, Response, ServerConfig

__all__ = ["LaneScheduler", "LatencyHistogram", "RangeServer", "Request",
           "Response", "ServerConfig", "REQUEST_OPS"]
