"""Architecture registry: ``from repro_torch.configs import base;
base.get(name)``."""
from repro_torch.configs.base import (ArchConfig, get, load_all, names,
                                      reduce_for_smoke)
