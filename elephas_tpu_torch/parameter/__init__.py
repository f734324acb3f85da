"""The host parameter servers and clients (port of ``elephas_tpu/parameter``):
HTTP, raw-TCP and native servers that asynchronous and hogwild workers pull
weights from and push deltas to, with the reference's wire formats."""

from .client import BaseParameterClient, HttpClient, SocketClient
from .server import BaseParameterServer, HttpServer, SocketServer

__all__ = [
    "BaseParameterClient",
    "HttpClient",
    "SocketClient",
    "BaseParameterServer",
    "HttpServer",
    "SocketServer",
]
