"""The ODiMO core (``repro.core`` counterparts): fake quantization, the
channel-wise DNAS state, the differentiable cost models and regularizers,
the baselines, the Fig. 3 discretization and the search's loss builder."""
