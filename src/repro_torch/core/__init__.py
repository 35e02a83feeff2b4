"""The ODiMO core (``repro.core`` counterparts): fake quantization, the
channel-wise DNAS state, the differentiable cost models and regularizers,
the baselines, the Fig. 3 discretization, the search's loss builder and
the domain -> tensor-parallel sub-group planning (`partition`)."""
