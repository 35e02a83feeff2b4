"""``python -m repro_torch.runtime``: the artifact -> plan lowering CLI
(`repro_torch.runtime.lower.main`)."""
from repro_torch.runtime.lower import main

if __name__ == "__main__":
    main()
