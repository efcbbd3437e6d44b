"""``repro_torch.serve.gateway`` — the streaming HTTP front door (twin of
``repro.serve.gateway``).

Stdlib-only serving layer over ``RalmEngine``: OpenAI-compatible
``/v1/completions`` with SSE streaming, per-tenant admission control
(429/503 backpressure), and graceful retrieval-quality degradation
under load::

    from repro_torch.serve.gateway import Gateway, GatewayConfig

    gw = Gateway(engine, GatewayConfig(port=8000))
    gw.serve_forever()        # or gw.start_background() from tests
"""
from repro_torch.serve.gateway.admission import (AdmissionController,
                                                 TenantQuota, TokenBucket,
                                                 Verdict)
from repro_torch.serve.gateway.degrade import (DegradeConfig, DegradeLevel,
                                               DegradePolicy)
from repro_torch.serve.gateway.server import Gateway, GatewayConfig

__all__ = [
    "AdmissionController", "DegradeConfig", "DegradeLevel",
    "DegradePolicy", "Gateway", "GatewayConfig", "TenantQuota",
    "TokenBucket", "Verdict",
]
