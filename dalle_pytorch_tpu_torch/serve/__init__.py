"""The serving tier of the port: page pool, prefix cache, queue, engine,
postprocess, the replica set and its autoscaler, the HTTP server, and the
gateway over cells of servers with its tenants.

The queue and tenant types import without torch; the gateway (whose
fault hooks import it) loads on first use."""

from dalle_pytorch_tpu_torch.serve.scheduler import (  # noqa: F401
    WeightedFairQueue)
from dalle_pytorch_tpu_torch.serve.tenancy import (  # noqa: F401
    TIERS, AuthError, TenantSpec, TenantTable, TenantThrottled,
    TokenBucket)


def __getattr__(name):
    if name in ("Gateway", "Cell", "make_gateway_http_server",
                "serve_gateway_http"):
        from dalle_pytorch_tpu_torch.serve import gateway
        return getattr(gateway, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
