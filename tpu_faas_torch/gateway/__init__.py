"""REST gateway: the four-endpoint HTTP API in front of the task store.

The reference never shipped this component (SURVEY §0.1 — its tests talk to an
external service on :8000); the API surface and the store-side contract are
reconstructed there and implemented here.
"""

from tpu_faas_torch.gateway.app import make_app, start_gateway_thread

__all__ = ["make_app", "start_gateway_thread"]
