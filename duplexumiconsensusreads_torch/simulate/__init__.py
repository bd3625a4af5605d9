from duplexumiconsensusreads_torch.simulate.simulator import (  # noqa: F401
    SimConfig,
    SimTruth,
    pad_batch,
    simulate_batch,
)
