"""Serving: dynamic micro-batching and the HTTP endpoint (port of
``islx/serve``)."""
from islx_torch.serve.batcher import MicroBatcher, PoseResult  # noqa: F401
from islx_torch.serve.http import PoseServer  # noqa: F401
