"""Multi-tenant fairness plane on PyTorch (counterpart of ``tpu_faas.tenancy``).

- :mod:`tpu_faas_torch.tenancy.config` — the tenant vocabulary, share and
  inflight-cap parsing, the hot-reload protocol over the
  ``fleet:tenant_conf`` store hash, and the host-side :class:`TenantTable`;
- :mod:`tpu_faas_torch.tenancy.fairshare` — the in-tick admission and
  deficit carry as torch ops: the batch tick runs them on its device, and
  the resident tick's plain version runs them on the CPU. On the card the
  resident tick runs the same lane inside kernel B1
  (``csrc/fused_tick.cu``).
"""

from tpu_faas_torch.tenancy.config import (  # noqa: F401
    DEFAULT_TENANT,
    TenantTable,
    parse_caps,
    parse_shares,
    valid_tenant,
)
