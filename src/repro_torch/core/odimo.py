"""The search configuration fields that artifact emission reads
(``repro.core.odimo.ODiMOSpec``); the DNAS search itself waits for the
search slice."""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core import quant
from repro_torch.core.quant import PrecisionDomain


@dataclasses.dataclass(frozen=True)
class ODiMOSpec:
    """Search configuration shared by every ODiMO-managed layer."""
    domains: Sequence[PrecisionDomain] = quant.DIANA_DOMAINS
    init_tau: float = 1.0
    final_tau: float = 0.05
    act_bits: int = 7          # worst case of the domains (Sec. III-B)

    @property
    def n_domains(self) -> int:
        return len(self.domains)
